"""How far the port of the panda arm's distillation parts from the JAX
package's yardstick (``data/distilled_panda_yardstick.py``), and how far runs
that differ by rounding alone part from each other: the numbers that set
the yardstick's bounds (c) and (d), and the elementwise bound of
``chip_smoke.py``'s one-pass gate of the U-Net pass's bf16 entry.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.distill_panda_divergence \\
        [--device cpu] [--rows] [--losses] [--paired] [--unet-pass] [--threads 4]

- ``--rows``: the committed 3-eval student's closed loop through the port's
  plain chain split (the 10 episodes as one batch, the plant ``panda_rbd``)
  over ``N_STEPS`` replans on the draws of each of ``SEED_FAMILIES`` seed
  families (family f: seeds 1000 f + i, ``distill_panda.seeded_draws``): the
  mean over the 10 episodes and over their first ``PREFIX_STEPS`` replans
  against (a)'s; the bound is twice the largest gap.
- ``--losses``: (b)'s ``N_DISTILL_STEPS`` distill steps in the port
  (``distill_losses``) on the same staged draws, from the teacher's weights
  and from 2 copies with a random 10% of their elements moved by one ulp
  (seeds 100, 101); each step's loss relative to (b)'s and to the unmoved
  run's; the bound is twice the largest.
- ``--paired``: (d)'s literals (``paired_prefix_costs`` on the CPU) and the
  gaps of fp32-sized perturbations from them: x0 moved by one ulp up, every
  eps moved by a relative 1e-6 (a fixed sign pattern), the bf16 entry's
  function (``bf16_conv_copy``); and of the controls that must fall outside
  the bound: the clip off, and each episode on the next seed's draws.
- ``--unet-pass``: the U-Net pass with bf16 conv kernels and its final 1x1
  conv in fp32 (``bf16_conv_copy(model, False)``, kernel 2's function)
  against the same function summed in float64, at ``chip_smoke.py``'s
  phase-49 shapes (the flagship's weights at horizon 32 and the distilled
  panda student's at 128, ``UNET_PASS_ROWS`` rows each, its distributions of
  x, t, context and mask) on ``UNET_PASS_SEEDS`` seeds: the largest
  elementwise gap of raw eps; the bound is twice it.

Prints one JSON object per mode; a CPU run of the first three takes ~10
minutes at 4 threads, the last ~1 minute.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from ..control import make_closed_loop
from ..core import make_schedule
from ..data import distilled_panda_yardstick as dpy
from ..data.datasets import ControlSequenceDataset
from ..data.panda_stats import panda_stats
from ..diffusion import GaussianDiffusion, make_distill_step, make_student_ddim_sampler
from ..dynamics.arm import make_panda_context, panda_cost, panda_rbd
from ..models import load_flagship, load_panda_student, load_panda_teacher
from ..models.bf16 import bf16_conv_copy
from ..train import ParamLayout, TrainState, make_optimizer
from ..utils.device import resolve_device
from . import distill_panda as dp
from .train_divergence import perturb

__all__ = ["distill_losses", "main"]

FLAGSHIP = dpy.ARTIFACTS / "flagship" / "ema_params.pkl"
UNET_PASS_ROWS, UNET_PASS_SEEDS, UNET_PASS_T = 64, 4, 25


def distill_losses(dev, perturb_seed: Optional[int] = None) -> dict:
    """(b)'s steps on ``dev``: ``make_distill_step`` from the teacher's weights (a random 10%
    moved by one ulp where ``perturb_seed`` is given) as teacher and student, on the staged
    draws of ``dpy.staged_draws``; each step's loss (``losses``) and the steps' milliseconds
    each by the host clock, synchronised (``ms_per_step``, the first step included)."""
    model = load_panda_teacher(dpy.TEACHER, device=dev)
    if perturb_seed is not None:
        model = perturb(model, perturb_seed)
    ds = ControlSequenceDataset.load(str(dpy.DATASET), device=dev)
    x_all, c_all = ds.inputs_normalized, ds.condition_normalized
    draws = dpy.staged_draws(x_all.shape[0])
    optimizer = make_optimizer(dpy.LR)
    layout = ParamLayout.of(model)
    teacher = {n: p.detach() for n, p in model.named_parameters()}
    step, _ = make_distill_step(make_schedule("exponential", dpy.T), model, optimizer, teacher,
                                dpy.TEACHER_TIMES, w=dpy.W, teacher_cfg=True)
    params = layout.flatten(teacher)
    state = TrainState(params, params.clone(), optimizer.init(params),
                       torch.zeros((), dtype=torch.int32, device=dev), layout)
    staged = [(torch.from_numpy(draws["idx"][n]).to(dev),
               {"j": torch.from_numpy(draws["j"][n]).to(dev),
                "noise": torch.from_numpy(draws["noise"][n]).to(dev)})
              for n in range(dpy.N_DISTILL_STEPS)]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    losses = []
    for idx, d in staged:
        state, met = step(state, x_all[idx], c_all[idx], d)
        losses.append(met["loss"])
    sync()
    ms = 1e3 * (time.perf_counter() - t0) / dpy.N_DISTILL_STEPS
    return {"losses": [float(v) for v in losses], "ms_per_step": ms}


def _rows(dev) -> dict:
    student = load_panda_student(dpy.STUDENT, device=dev)
    ins, cond = (st.to(dev) for st in panda_stats())
    loop, _ = dp.chain_loop(student, dpy.TIMES, dpy.N_SEEDS, dpy.N_STEPS, dpy.H, dev, ins, cond)
    runs = []
    for f in range(dpy.SEED_FAMILIES):
        noise = dp.seeded_draws(range(1000 * f, 1000 * f + dpy.N_SEEDS), dpy.N_STEPS, dpy.H, dev)
        stages = loop(torch.from_numpy(dpy.x0()).to(dev).expand(dpy.N_SEEDS, 14),
                      noise).stage_costs.double()
        costs, prefix = stages.sum(-1).tolist(), stages[:, :dpy.PREFIX_STEPS].sum(-1).tolist()
        runs.append({"family": f, "mean10": float(np.mean(costs)),
                     "prefix_mean10": float(np.mean(prefix)), "gaps": dpy.gaps(costs, prefix)})
        print(json.dumps(runs[-1]), flush=True)
    worst = {k: max(r["gaps"][k] for r in runs) for k in ("mean10", "prefix")}
    return {"runs": runs, "largest_gaps": worst, "bounds": {k: 2 * v for k, v in worst.items()}}


def _losses(dev) -> dict:
    base = distill_losses(dev)["losses"]
    runs = {"unmoved": {"losses": base, "vs_yardstick": dpy.loss_gaps(base)}}
    for seed in (100, 101):
        ls = distill_losses(dev, seed)["losses"]
        runs[f"ulp_{seed}"] = {"losses": ls, "vs_yardstick": dpy.loss_gaps(ls),
                               "vs_unmoved": [abs(a - b) / abs(b) for a, b in zip(ls, base)]}
    largest = max(max(r["vs_yardstick"]) for r in runs.values())
    return {"runs": runs, "largest_gap": largest, "bound": 2 * largest}


def _paired(dev) -> dict:
    literal = dpy.paired_prefix_costs(dev)
    student = load_panda_student(dpy.STUDENT, device=dev)
    ins, cond = (st.to(dev) for st in panda_stats())
    schedule = make_schedule("exponential", dpy.T)
    signs = torch.sign(torch.sin(torch.arange(dpy.N_SEEDS * dpy.H * 7, dtype=torch.float32)))
    signs = signs.reshape(dpy.N_SEEDS, dpy.H, 7).to(dev)
    moved = lambda x, t, c, m: student(x, t, c, m) * (1 + 1e-6 * signs[:x.shape[0]])
    noise = dp.seeded_draws(range(dpy.PAIRED_SEED_BASE, dpy.PAIRED_SEED_BASE + dpy.N_SEEDS),
                            dpy.PREFIX_STEPS, dpy.H, dev)

    plant = panda_rbd()
    step_signs = torch.sign(torch.sin(torch.arange(dpy.N_SEEDS * 14, dtype=torch.float32) + 0.5))
    step_moved = dataclasses.replace(plant, step=lambda x, u: plant.step(x, u) * (
        1 + 1e-6 * step_signs.reshape(dpy.N_SEEDS, 14).to(x.device)))

    def run(denoise=student, start=dpy.x0(), draws=noise, clip_denoised=True, plant=plant):
        loop = make_closed_loop(GaussianDiffusion(schedule), student, ins, cond, plant,
                                panda_cost(), horizon=dpy.H, n_steps=dpy.PREFIX_STEPS,
                                state_to_condition=make_panda_context(),
                                sample_override=make_student_ddim_sampler(
                                    schedule, denoise, dpy.TIMES, clip_denoised),
                                noise_shape=(1, dpy.H, 7), device=dev)
        res = loop(torch.from_numpy(start).to(dev).expand(dpy.N_SEEDS, 14), draws)
        return [abs(a - b) for a, b in zip(res.stage_costs.double().sum(-1).tolist(), literal)]

    perturbed = {"x0_ulp_up": run(start=np.nextafter(dpy.x0(), np.float32(np.inf))),
                 "eps_1e-6": run(moved), "state_1e-6": run(plant=step_moved),
                 }
    controls = {"bf16_function": run(bf16_conv_copy(student)),
                "clip_off": run(clip_denoised=False),
                "next_seed_draws": run(draws=torch.roll(noise, 1, 0))}
    largest = max(max(g) for g in perturbed.values())
    return {"paired_prefix": literal, "perturbed_gaps": perturbed, "control_gaps": controls,
            "largest_gap": largest, "bound": 2 * largest,
            "controls_outside": {k: min(g) > 2 * largest for k, g in controls.items()}}


def _unet_pass(dev) -> dict:
    shapes = {"flagship": (load_flagship(FLAGSHIP, device=dev), 32, 1, 5),
              "panda": (load_panda_student(dpy.STUDENT, device=dev), dpy.H, 7, 20)}
    gaps = {}
    for name, (model, h, d, c) in shapes.items():
        fn = bf16_conv_copy(model, False)
        f64 = bf16_conv_copy(copy.deepcopy(model).double(), False)
        gaps[name] = []
        for seed in range(UNET_PASS_SEEDS):
            gen = torch.Generator(device=dev).manual_seed(seed)
            n = UNET_PASS_ROWS
            x = torch.randn((n, h, d), generator=gen, device=dev)
            t = torch.randint(0, UNET_PASS_T, (n,), generator=gen, device=dev)
            ctx = torch.rand((n, c), generator=gen, device=dev) * 2 - 1
            mask = (torch.rand((n, 1), generator=gen, device=dev) < 0.5).float()
            got = fn(x, t, ctx, mask).double()
            want = f64(x.double(), t, ctx.double(), mask.double())
            gaps[name].append(float((got - want).abs().max()))
        print(json.dumps({"unet_pass": name, "gaps": gaps[name]}), flush=True)
    largest = max(max(g) for g in gaps.values())
    return {"rows": UNET_PASS_ROWS, "gaps": gaps, "largest_gap": largest, "bound": 2 * largest}


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cpu")
    p.add_argument("--rows", action="store_true")
    p.add_argument("--losses", action="store_true")
    p.add_argument("--paired", action="store_true")
    p.add_argument("--unet-pass", action="store_true")
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    dev = resolve_device(args.device)
    out = {"device": str(dev), "threads": args.threads}
    with torch.no_grad():
        if args.rows:
            out["rows"] = _rows(dev)
            print(json.dumps({"rows": out["rows"]}), flush=True)
        if args.paired:
            out["paired"] = _paired(dev)
            print(json.dumps({"paired": out["paired"]}), flush=True)
        if args.unet_pass:
            out["unet_pass"] = _unet_pass(dev)
            print(json.dumps({"unet_pass": out["unet_pass"]}), flush=True)
    if args.losses:
        out["losses"] = _losses(dev)
        print(json.dumps({"losses": out["losses"]}), flush=True)
    return out


if __name__ == "__main__":
    main()
