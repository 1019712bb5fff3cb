"""Trains the AMPC (MLP) baseline on the card: the JAX package's
``scripts/train_ampc.py``, in the port.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.train_ampc --dataset PATH.npz \\
        [--results-dir build/ampc] [--steps 20000] [--device cpu]

Regresses the normalized u-horizon from the normalized x0 with the
reference's 5 -> 2 -> 50 -> 50 -> H tanh MLP (``models.AMPCNet``): the mean
square, plain Adam (lr ``--lr``, no clip) and an EMA of ``--ema-decay`` at
every step, batches of ``--batch-size`` drawn from a ``torch.Generator``
seeded ``--seed`` on the device; the initial weights are flax's Dense init
drawn from ``RandomState(--seed)``. Writes ``ampc.ckpt`` into
``--results-dir`` with the JAX file's keys (``params``, ``ema_params`` in
the flax layout, ``horizon``, ``control_dim``), which ``models.load_ampc``
and the JAX package read.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data.datasets import ControlSequenceDataset
from ..models import AMPCNet, init_mlp_like_flax, mlp_to_flax_params
from ..train.regression import fit_regression_flat
from ..utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]
LOG_EVERY = 2000


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", required=True)
    p.add_argument("--results-dir", default=str(ROOT / "build" / "ampc"))
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ema-decay", type=float, default=0.995)
    p.add_argument("--seed", type=int, default=30)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    ds = ControlSequenceDataset.load(args.dataset, device=dev)
    model = AMPCNet(horizon=ds.n_support_points, control_dim=ds.state_dim,
                    state_dim=ds.condition_dim)
    init = mlp_to_flax_params(init_mlp_like_flax(model, np.random.RandomState(args.seed)))
    log = lambda s, v: print(f"step {s}/{args.steps} mse {v:.6f}", flush=True)
    t0 = time.perf_counter()
    layout, params, ema, loss = fit_regression_flat(
        model.to(dev), ds.inputs_normalized, ds.condition_normalized, init, args.steps,
        args.batch_size, args.lr, args.ema_decay,
        torch.Generator(device=dev).manual_seed(args.seed), LOG_EVERY, log)
    seconds = time.perf_counter() - t0
    os.makedirs(args.results_dir, exist_ok=True)
    path = os.path.join(args.results_dir, "ampc.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"params": mlp_to_flax_params(model, layout.views(params)),
                     "ema_params": mlp_to_flax_params(model, layout.views(ema)),
                     "horizon": ds.n_support_points, "control_dim": ds.state_dim}, f)
    print(f"saved {path} ({args.steps} steps in {seconds:.3f}s, last mse {loss})", flush=True)
    return {"path": path, "final_loss": loss, "seconds": seconds, "steps": args.steps}


if __name__ == "__main__":
    main()
