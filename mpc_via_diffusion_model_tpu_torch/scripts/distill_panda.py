"""Progressive distillation of the panda arm's CFG teacher on the card: the
JAX package's ``scripts/distill_panda.py``, in the port.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.distill_panda \\
        [--teacher artifacts/flagship_panda_rbd] [--out build/distill_panda] \\
        [--steps-per-round 20000] [--rounds 3] [--eval-seeds 10] [--steps 80] \\
        [--init-student PKL --init-times 23,15,7] [--device cpu]

The teacher (the 25-step CFG ``TemporalUnet`` of ``PANDA_STUDENT_CONFIG``:
horizon 128, 7 control channels, the 20-dim context of
``make_panda_context``, two U-Net passes per step) is distilled into
conditional-only DDIM students of 12, 6 and 3 U-Net passes, the guidance
weight baked in by the first round (``diffusion/distillation.py``).

- The teacher's weights: ``--teacher``'s ``ema_params.pkl``
  (``models.load_panda_teacher``). The JAX script reads the training run's
  ``checkpoints/final.ckpt``, which the repository does not hold; the EMA
  pickle beside it holds the same weights.
- Data: ``--teacher``'s ``dataset.npz``, normalized with its own limits,
  which are ``data/panda_stats.py``'s literals exactly. Where the file is
  absent (a run of ``--rounds 0``) the evaluation uses those literals; a
  round needs the dataset.
- The rounds (the JAX script's ``:137-185``): each halves the grid, starting
  from ``ddim_time_grid(25, t_start=23)`` (or ``--init-times`` with
  ``--init-student``); the student starts as its teacher and trains
  ``--steps-per-round`` steps in chunks of ``--chunk``
  (``make_distill_step`` under ``make_scanned_train_steps``, lr ``--lr``
  with the clip at 1, draws from a ``torch.Generator`` seeded 40 + round);
  CFG only in the first round of a run from the teacher. Its EMA is saved as
  ``student_{n}eval.pkl`` (``{'params'}``, the flax layout the JAX package
  pickles and ``models.load_panda_student`` reads) and is the next round's
  teacher.
- Evaluation (``eval_student``): ``--eval-seeds`` closed loops of
  ``--steps`` replans from x0 = 0.3 rad on every joint at rest, each
  seed's initial draws from a CPU ``torch.Generator`` seeded with its index
  (the same numbers on every device), through the chain split, the JAX
  script's route: the DDIM chain kernel (kernel 4) as
  ``make_closed_loop``'s ``sample_override`` with the episodes as its
  samples, the arm ``panda_rbd`` stepped in torch.
- The final student's fused-chain rows (the JAX script's ``:186-217``): the
  3-eval chain through kernel 4 at ``n_samples=1`` in fp32 and in bf16
  (``ddim_chain_bf16``) as ``sample_override``, the arm stepped outside the
  kernel: ``fused_chain_hz_{fp32,bf16}`` is ``--steps`` over the pipelined
  seconds of one episode (``eval/timing.py``: 8 episodes issued back to
  back, best of ``--rate-batches``), ``fused_chain_cost_ratio_{fp32,bf16}``
  one episode's cost (its draws seeded 3) over the expert's.

The flags are the JAX script's, with ``--device cpu`` in place of its
``--cpu``. ``--init-student artifacts/distilled_panda/student_3eval.pkl
--init-times 23,15,7 --rounds 0`` runs only the fused-chain rows on the
committed student, as the JAX script's flags allow.

``report.json`` has the JAX script's keys; beside them each evaluation's
route and launches, the training rate, and the card's name and power limit
(``nvidia-smi``). Unlike the JAX script, which records ``None`` for a
fused-chain row whose kernel raised, a kernel's failure here ends the run
with a non-zero exit: a row that silently fell away would read as a result.
The expert's and the teacher's costs come from ``--teacher``'s
``report.json``, TPU figures that are no target here. ``--out`` may not lie
under ``artifacts/``, the JAX package's record.
"""
from __future__ import annotations

import argparse
import json
import pickle
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..control import make_closed_loop
from ..core import make_schedule
from ..data.datasets import ControlSequenceDataset
from ..data.panda_stats import panda_stats
from ..diffusion import GaussianDiffusion, ddim_time_grid, make_distill_step
from ..dynamics.arm import make_panda_context, panda_cost, panda_rbd
from ..eval.timing import pipelined_time_fn
from ..models import PANDA_STUDENT_CONFIG, TemporalUnet, from_flax_params, to_flax_params
from ..ops.fused_denoise import make_fused_ddim_chain
from ..train import ParamLayout, TrainState, make_optimizer, make_scanned_train_steps
from ..utils.device import resolve_device

__all__ = ["x0", "unet", "seeded_draws", "chain_loop", "eval_student", "fused_chain_row", "main"]

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "distill_panda"
T, ROUND_SEED, RATE_SEED, COST_SEED, N_RATE = 25, 40, 3, 3, 8


def x0(dev=None) -> torch.Tensor:
    """The protocol's start: 0.3 rad on every joint of the shifted state, at rest."""
    return torch.cat([torch.full((7,), 0.3), torch.zeros(7)]).to(dev)


def unet(flax_params, horizon: int, dev) -> TemporalUnet:
    """The panda's architecture at ``horizon`` with the context-present bit, on ``dev``."""
    model = TemporalUnet(**dict(PANDA_STUDENT_CONFIG, n_support_points=horizon), cfg_indicator=True)
    model.load_state_dict(from_flax_params(flax_params))
    return model.to(dev).eval()


def seeded_draws(seeds, n_steps: int, horizon: int, dev) -> torch.Tensor:
    """(len(seeds), n_steps, 1, horizon, 7): each episode's initial draws of its replans from a
    CPU ``torch.Generator`` seeded with its seed, the same numbers on every device."""
    return torch.stack([
        torch.randn((n_steps, 1, horizon, 7), generator=torch.Generator().manual_seed(int(s)))
        for s in seeds]).to(dev)


def chain_loop(student, times, n_episodes: int, n_steps: int, horizon: int, dev, ins, cond,
               weights_dtype=torch.float32):
    """(loop, chain): the chain split of ``n_episodes`` closed loops at once, the DDIM chain
    kernel over ``times`` at ``n_episodes`` samples as the sampler, the arm ``panda_rbd``
    stepped in torch; ``loop(x0 (n_episodes, 14) or (14,) for one, noise (n_episodes,
    n_steps, 1, H, 7) or (n_steps, 1, H, 7))``."""
    schedule = make_schedule("exponential", T)
    chain = make_fused_ddim_chain(student, schedule, times, n_samples=n_episodes,
                                  weights_dtype=weights_dtype, device=dev)
    loop = make_closed_loop(GaussianDiffusion(schedule), student, ins, cond, panda_rbd(),
                            panda_cost(), horizon=horizon, n_steps=n_steps,
                            state_to_condition=make_panda_context(), sample_override=chain,
                            noise_shape=(1, horizon, 7), device=dev)
    return loop, chain


def eval_student(student, times, seeds, n_steps: int, horizon: int, dev, ins, cond) -> dict:
    """The JAX script's ``eval_student`` on the seeded draws of ``seeds`` through the chain
    split (``chain_loop``, the episodes as the chain's samples): each episode's summed stage
    cost, their mean and spread, whether every state stayed finite, the kernel and its
    launches."""
    loop, chain = chain_loop(student, times, len(seeds), n_steps, horizon, dev, ins, cond)
    res = loop(x0(dev).expand(len(seeds), 14), seeded_draws(seeds, n_steps, horizon, dev))
    costs = res.stage_costs.double().sum(-1).cpu().numpy()
    return {"closed_loop_cost_mean": float(costs.mean()), "closed_loop_cost_std": float(costs.std()),
            "all_finite": bool(torch.isfinite(res.x_track).all()), "costs": costs.tolist(),
            "kernel": chain.entry, "launches": chain.launches, "plain_calls": chain.plain_calls}


def fused_chain_row(student, times, n_steps: int, horizon: int, dev, ins, cond, weights_dtype,
                    rate_batches: int) -> dict:
    """One fused-chain row: the chain through kernel 4 at one sample, the arm outside it; its
    pipelined rate (``eval/timing.py``) and one episode's cost (draws seeded COST_SEED)."""
    loop, chain = chain_loop(student, times, 1, n_steps, horizon, dev, ins, cond, weights_dtype)
    start = x0(dev)
    rate_noise = seeded_draws(range(RATE_SEED * 1000, RATE_SEED * 1000 + N_RATE), n_steps,
                              horizon, dev)
    dt = pipelined_time_fn(lambda x, z: loop(x, z).x_track,
                           [(start, rate_noise[i]) for i in range(N_RATE)], rate_batches)
    chain.launches = chain.plain_calls = 0
    res = loop(start, seeded_draws([COST_SEED], n_steps, horizon, dev)[0])
    return {"hz": n_steps / dt, "cost": float(res.stage_costs.double().sum()),
            "finite": bool(torch.isfinite(res.x_track).all()), "kernel": chain.entry,
            "launches": chain.launches, "plain_calls": chain.plain_calls}


def _card(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--teacher", default=str(ROOT / "artifacts" / "flagship_panda_rbd"))
    p.add_argument("--out", default=str(OUT))
    p.add_argument("--horizon", type=int, default=128)
    p.add_argument("--w", type=float, default=0.01)
    p.add_argument("--steps-per-round", type=int, default=20000)
    p.add_argument("--chunk", type=int, default=250)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--eval-seeds", type=int, default=10)
    p.add_argument("--steps", type=int, default=80, help="closed-loop replans of every evaluation")
    p.add_argument("--init-student", default=None,
                   help="resume from a saved student .pkl (skips earlier rounds); requires "
                        "--init-times")
    p.add_argument("--init-times", default=None,
                   help="comma-separated DDIM grid of --init-student, e.g. '23,15,7'")
    p.add_argument("--rate-batches", type=int, default=3)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if (args.init_student is None) != (args.init_times is None):
        p.error("--init-student and --init-times must be given together")
    out = Path(args.out).resolve()
    if (ROOT / "artifacts").resolve() in (out, *out.parents):
        p.error("--out may not lie under artifacts/: its files are the JAX package's record")
    dev = resolve_device(args.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    out.mkdir(parents=True, exist_ok=True)
    teacher_dir = Path(args.teacher)
    data_path = teacher_dir / "dataset.npz"
    if data_path.exists():
        ds = ControlSequenceDataset.load(str(data_path), device=dev)
        ins, cond = (ds.normalizer.stats[k].to(dev) for k in ("inputs", "condition"))
    elif args.rounds > 0:
        p.error(f"{data_path} is missing: the rounds train on the teacher's dataset")
    else:
        ds, (ins, cond) = None, (st.to(dev) for st in panda_stats())
    flagship = json.loads((teacher_dir / "report.json").read_text())
    expert_cost = flagship["closed_loop_cost_nmpc"]
    teacher_cost = flagship["closed_loop_cost_diffusion_mean10"]
    report = {"teacher": args.teacher, "expert_closed_loop_cost": expert_cost,
              "teacher_closed_loop_cost_mean10": teacher_cost, "w": args.w, "rounds": [],
              "device": str(dev), "card": _card(dev),
              "eval_route": "the chain split: kernel 4 as sample_override, the arm in torch",
              "data": {"source": str(data_path) if ds is not None else "data/panda_stats.py",
                       "n_samples": ds.n_init if ds is not None else None}}
    seeds = range(args.eval_seeds)
    schedule = make_schedule("exponential", T)

    times = ddim_time_grid(T, t_start=23)
    with open(args.init_student or teacher_dir / "ema_params.pkl", "rb") as f:
        ckpt = pickle.load(f)
    cur = ckpt if args.init_student is not None else ckpt["ema_params"]  # flax trees
    if args.init_student is not None:
        times = [int(t) for t in args.init_times.split(",")]
        if any(t < 0 or t >= T for t in times):
            raise SystemExit(f"--init-times entries must be in [0, {T}): got {times}")
        if times != sorted(times, reverse=True) or len(set(times)) != len(times):
            raise SystemExit(f"--init-times must be strictly decreasing (DDIM grid, high t "
                             f"first): got {times}")
        report["init_student"] = args.init_student
        print(f"[init] resuming from {args.init_student} on grid {times}", flush=True)
    optimizer = make_optimizer(args.lr)
    n_chunks = args.steps_per_round // args.chunk
    for r in range(args.rounds):
        model = unet(cur, args.horizon, dev)
        layout = ParamLayout.of(model)
        teacher_params = {n: q.detach() for n, q in model.named_parameters()}
        step_fn, student_times = make_distill_step(
            schedule, model, optimizer, teacher_params, times, w=args.w,
            teacher_cfg=(r == 0 and args.init_student is None))
        chunk = make_scanned_train_steps(step_fn, args.chunk)
        params = layout.flatten(teacher_params)
        state = TrainState(params, params.clone(), optimizer.init(params),
                           torch.zeros((), dtype=torch.int32, device=dev), layout)
        gen = torch.Generator(device=dev).manual_seed(ROUND_SEED + r)
        losses = []
        sync()
        t0 = time.perf_counter()
        for c in range(n_chunks):
            state, chunk_losses = chunk(state, ds.inputs_normalized, ds.condition_normalized,
                                        args.batch_size, gen, per_step=True)
            losses.append(float(chunk_losses[-1]))
            if (c + 1) % max(1, n_chunks // 5) == 0:
                print(f"[round {r}] step {(c + 1) * args.chunk} loss {losses[-1]:.6f} "
                      f"({(c + 1) * args.chunk / (time.perf_counter() - t0):.2f} steps/s)",
                      flush=True)
        sync()
        t_train = time.perf_counter() - t0
        student = to_flax_params(layout.views(state.ema_params))
        with open(out / f"student_{len(student_times)}eval.pkl", "wb") as f:
            pickle.dump(student, f)
        m = eval_student(unet(student, args.horizon, dev), student_times, seeds, args.steps,
                         args.horizon, dev, ins, cond)
        steps = n_chunks * args.chunk
        rec = {"n_evals": len(student_times), "times": [int(t) for t in student_times],
               "train_seconds": t_train, "final_loss": losses[-1] if losses else None,
               "cost_ratio_vs_expert": m["closed_loop_cost_mean"] / expert_cost,
               "cost_ratio_vs_teacher": m["closed_loop_cost_mean"] / teacher_cost, **m,
               "steps": steps, "ms_per_step": 1e3 * t_train / steps if steps else None,
               "teacher_cfg": r == 0 and args.init_student is None, "chunk_last_losses": losses}
        report["rounds"].append(rec)
        print(f"[round {r}] {len(student_times)}-eval student: cost "
              f"{m['closed_loop_cost_mean']:.3f} ({rec['cost_ratio_vs_expert']:.4f}x expert) "
              f"through {m['kernel']} ({m['launches']} launches); {steps} steps in "
              f"{t_train:.3f}s", flush=True)
        cur, times = student, student_times

    final = unet(cur, args.horizon, dev)
    for wd, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        row = fused_chain_row(final, times, args.steps, args.horizon, dev, ins, cond, wd,
                              args.rate_batches)
        report[f"fused_chain_hz_{tag}"] = row["hz"]
        report[f"fused_chain_cost_ratio_{tag}"] = row["cost"] / expert_cost
        report[f"fused_chain_{tag}"] = row
        print(f"[fused chain {tag}] {row['hz']:.3f} Hz, cost {row['cost']:.6f} "
              f"({report[f'fused_chain_cost_ratio_{tag}']:.6f}x expert) through {row['kernel']} "
              f"({row['launches']} launches, {row['plain_calls']} plain calls); {report['card']}",
              flush=True)

    (out / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
