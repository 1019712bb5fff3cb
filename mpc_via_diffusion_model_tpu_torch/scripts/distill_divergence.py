"""How far the port's distillation parts from the JAX package's yardstick,
and how far two runs that differ by rounding alone part from each other.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.distill_divergence [--device cpu] \\
        [--perturbed 4] [--steps 60]

Runs yardstick (a) of ``data/distill_yardstick.py`` (the teacher's weights,
``synthetic_data()``, the staged draws of ``RandomState(2)``; 50 steps of
round 0, then round 1 on round 0's EMA) through ``distill_steps``, then the
same from ``--perturbed`` initial weights, each with a random 10% of its
elements moved by one ulp (seeds 100, 101, ...). Prints one JSON object:
per run, the largest relative loss difference from the yardstick over
steps 1-10, 11-50, 51-60 and all, the relative checksum differences at the
yardstick's check steps, and the perturbed runs the same against the
unperturbed one. chip_smoke's phase 29 bounds (``data/distill_yardstick.py``
(d)) are set from these numbers.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from ..core import make_schedule
from ..data import distill_yardstick as dys
from ..diffusion import ddim_time_grid, make_distill_step
from ..models import TemporalUnet, load_teacher
from ..train import ParamLayout, TrainState, make_optimizer, make_scanned_train_steps
from ..utils.device import resolve_device
from .train_divergence import perturb

WINDOWS = ((0, 10), (10, 50), (50, 60), (0, None))


def teacher_model(dev, perturb_seed: Optional[int] = None) -> TemporalUnet:
    """The yardstick's teacher on ``dev``, a random 10% of its weights moved
    by one ulp when ``perturb_seed`` is given."""
    model = load_teacher(dys.TEACHER, device=dev)
    return model if perturb_seed is None else perturb(model, perturb_seed)


def distill_steps(model: TemporalUnet, dev, n_steps: int = dys.ROUND0_STEPS + dys.ROUND1_STEPS,
                  check=dys.CHECK_STEPS):
    """Yardstick (a)'s steps on ``dev`` from ``model``'s weights (teacher and
    student alike): a dict of ``losses`` (n,) float64 and ``skipped`` (n,)
    bool on the CPU, ``sums`` (the checksums of the params and the EMA at
    each ``check`` step), ``emas`` (each round's last EMA, flat on ``dev``)
    and ``layout``. The steps between two check steps are one
    ``make_scanned_train_steps`` chunk on the staged draws."""
    x_all, c_all = (torch.from_numpy(a).to(dev) for a in dys.synthetic_data())
    draws = {k: torch.from_numpy(v).to(dev) for k, v in dys.staged_draws().items()}
    schedule = make_schedule("exponential", dys.T)
    optimizer = make_optimizer(dys.LR)
    layout = ParamLayout.of(model)
    teacher = {n: p.detach() for n, p in model.named_parameters()}
    times = ddim_time_grid(dys.T, t_start=dys.T_START)
    losses, skipped, sums, emas, done = [], [], {}, [], 0
    for n_round, cfg in ((dys.ROUND0_STEPS, True), (dys.ROUND1_STEPS, False)):
        n_round = min(n_round, n_steps - done)
        if n_round <= 0:
            break
        step_fn, times_next = make_distill_step(schedule, model, optimizer, teacher, times,
                                                w=dys.W, teacher_cfg=cfg)
        params = layout.flatten(teacher)
        state = TrainState(params, params.clone(), optimizer.init(params),
                           torch.zeros((), dtype=torch.int32, device=dev), layout)
        skips = []

        def step_fn_logged(st, x, c, d, _step=step_fn):
            st, met = _step(st, x, c, d)
            skips.append(met["update_skipped"])
            return st, met

        # every check step ends a chunk, so each state is seen
        bounds = sorted({done} | {s for s in check if done < s <= done + n_round}
                        | {done + n_round})
        for a, b in zip(bounds, bounds[1:]):
            chunk = make_scanned_train_steps(step_fn_logged, b - a)
            state, ls = chunk(state, x_all, c_all, dys.BATCH,
                              {k: v[a:b] for k, v in draws.items()}, per_step=True)
            losses.append(ls)
            if b in check:
                sums[b] = {"params": dys.checksum([state.params]),
                           "ema": dys.checksum([state.ema_params])}
        skipped += skips
        done += n_round
        emas.append(state.ema_params)
        teacher, times = layout.views(state.ema_params), times_next
    return {"losses": torch.cat(losses).cpu().double().numpy(),
            "skipped": torch.stack(skipped).cpu().numpy(), "sums": sums, "emas": emas,
            "layout": layout}


def loss_gaps(losses: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    rel = np.abs(losses / want[:len(losses)] - 1)
    n = len(losses)
    return {f"max_{a + 1}_{min(b or n, n)}": float(rel[a:b].max()) for a, b in WINDOWS if a < n}


def checksum_gaps(sums: Dict, want: Dict) -> Dict[str, float]:
    """Per check step, the largest relative difference of the three sums of the params and the EMA."""
    out = {}
    for step, got in sums.items():
        w = want[step]
        out[str(step)] = max(abs(g / v - 1) for k in ("params", "ema") for g, v in zip(got[k], w[k]))
    return out


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--perturbed", type=int, default=4)
    p.add_argument("--steps", type=int, default=dys.ROUND0_STEPS + dys.ROUND1_STEPS)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    want = np.asarray(dys.LOSSES)
    want_sums = {s: dys.CHECKSUMS[s] for s in dys.CHECK_STEPS}
    runs = []
    for i in range(args.perturbed + 1):
        seed = 100 + i - 1 if i else None
        res = distill_steps(teacher_model(dev, seed), dev, args.steps)
        losses, sums = res["losses"], res["sums"]
        run = {"perturbed_seed": seed, "any_update_skipped": bool(res["skipped"].any()),
               "vs_yardstick": {**loss_gaps(losses, want), "checksums": checksum_gaps(sums, want_sums)}}
        if i:
            base = runs[0]
            run["vs_unperturbed"] = {**loss_gaps(losses, base["losses"]),
                                     "checksums": checksum_gaps(sums, base["sums"])}
        run["losses"], run["sums"] = losses, sums
        runs.append(run)
        print(json.dumps({k: v for k, v in run.items() if k not in ("losses", "sums")}), flush=True)
    out = {"device": str(dev), "threads": torch.get_num_threads(), "steps": args.steps,
           "runs": [{k: v for k, v in r.items() if k not in ("losses", "sums")} for r in runs]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
