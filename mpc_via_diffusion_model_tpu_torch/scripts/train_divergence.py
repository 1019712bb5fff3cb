"""How far the port's training parts from the JAX package's yardstick, and
how far two runs that differ by rounding alone part from each other.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.train_divergence [--device cpu] \\
        [--perturbed 6] [--steps 200]

Runs the yardstick's steps (``data/lmpc_train_yardstick.py``: the recipe's
dataset, ``init_like_flax`` from ``RandomState(1)``, the staged draws of
``RandomState(2)``) as one ``make_scanned_train_steps`` chunk, then the same
from ``--perturbed`` initial weights, each with a random 10% of its
elements moved by one ulp (seeds 100, 101, ...). Prints one JSON object:
per run, the largest relative loss difference from the yardstick over
steps 1-10, 11-50, 51-100 and all, and that of the mean of the last 20
steps; the perturbed runs also against the unperturbed one. These are the
numbers chip_smoke's phase 24 gates are set from.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from ..core import make_schedule
from ..data import lmpc_train_yardstick as ys
from ..diffusion import GaussianDiffusion
from ..train import Trainer, make_scanned_train_steps
from ..utils.device import resolve_device
from . import flagship_lmpc

WINDOWS = ((0, 10), (10, 50), (50, 100), (0, None))
TAIL = 20


def perturb(model: torch.nn.Module, seed: int, share: float = 0.1) -> torch.nn.Module:
    """Moves a random ``share`` of every parameter's elements by one ulp, up or down."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            pick = torch.rand(p.shape, generator=gen) < share
            up = torch.rand(p.shape, generator=gen) < 0.5
            inf = torch.full_like(p, float("inf"))
            moved = torch.where(up.to(p.device), torch.nextafter(p, inf), torch.nextafter(p, -inf))
            p.copy_(torch.where(pick.to(p.device), moved, p))
    return model


def divergence(losses: np.ndarray, want: np.ndarray) -> dict:
    rel = np.abs(losses / want - 1)
    n = len(losses)
    out = {f"max_{a + 1}_{min(b or n, n)}": float(rel[a:b].max()) for a, b in WINDOWS if a < n}
    out[f"tail{TAIL}_mean"] = float(abs(losses[-TAIL:].mean() / want[-TAIL:].mean() - 1))
    return out


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--perturbed", type=int, default=6)
    p.add_argument("--steps", type=int, default=ys.N_STEPS)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    ds = flagship_lmpc.collect_recipe_dataset(dev)
    draws = {k: torch.from_numpy(v[:args.steps]).to(dev)
             for k, v in ys.staged_draws(ds.n_init).items()}
    want = np.asarray(ys.LOSSES[:args.steps])
    runs = []
    for i in range(args.perturbed + 1):
        model = flagship_lmpc.lmpc_model(dev)
        if i:
            perturb(model, 100 + i - 1)
        trainer = Trainer(GaussianDiffusion(make_schedule("exponential", flagship_lmpc.T)), model,
                          lr=flagship_lmpc.LR, device=dev)
        chunk = make_scanned_train_steps(trainer.train_step, args.steps)
        _, losses = chunk(trainer.state, ds.inputs_normalized, ds.condition_normalized, ys.BATCH,
                          draws, per_step=True)
        losses = losses.cpu().double().numpy()
        run = {"perturbed_seed": 100 + i - 1 if i else None,
               "vs_yardstick": divergence(losses, want)}
        if i:
            run["vs_unperturbed"] = divergence(losses, runs[0]["losses"])
        run["losses"] = losses
        runs.append(run)
    out = {"device": str(dev), "threads": torch.get_num_threads(), "steps": args.steps,
           "runs": [{k: v for k, v in r.items() if k != "losses"} for r in runs]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
