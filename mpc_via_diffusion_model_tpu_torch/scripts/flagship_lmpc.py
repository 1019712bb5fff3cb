"""The LMPC recipe on the card: collect the LQR expert's dataset, train the
horizon-8 denoiser on it, and run the parity evaluation on the model it
trained, the three steps of the JAX package's ``scripts/flagship_lmpc.py``.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.flagship_lmpc [--train-steps 230000] \\
        [--out chiprun_out/flagship_lmpc] [--device cpu]

1. ``collect_recipe_dataset``: the recipe of the committed weights' commit
   (``data/lmpc_stats.py``, steps 1-4; 146,250 samples) through
   ``collect_lmpc_dataset`` and the LQR solver on the device. The grid's
   noisy replicas come from ``np.random.RandomState(0)`` where that commit
   drew them from JAX's ``PRNGKey(0)``, so the condition limits differ from
   ``lmpc_stats()``'s; both are printed.
2. ``TemporalUnet`` of ``LMPC_CONFIG`` with the context-present bit,
   initialized by ``init_like_flax`` from ``RandomState(1)``, trained by
   ``Trainer.fit`` in chunks of 250 steps at batch 512 and lr 3e-3 on the
   exponential schedule of 25 steps, its draws from a ``torch.Generator``
   seeded 2 on the device.
3. ``lmpc_parity.run``'s episode route (``cfg_episode_lmpc``) on the EMA
   weights, reloaded from the pickle, with step 1's statistics.

Writes into ``--out`` (git-ignored by default, never ``artifacts/``):
``dataset.npz``, ``checkpoints/final.ckpt`` (the JAX package's checkpoint
payload), ``ema_params.pkl`` (``{'ema_params', 'step', 'cfg_indicator',
'horizon'}``, the flax layout, which ``models.load_lmpc`` and the JAX
package both read) and ``report.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core import make_schedule
from ..data.datasets import ControlSequenceDataset
from ..data.generation import collect_lmpc_dataset
from ..data.lmpc_stats import LMPC_U_L1_SUMMARY, lmpc_stats
from ..diffusion import GaussianDiffusion
from ..dynamics import cartpole_lmpc, cartpole_lmpc_cost
from ..models import LMPC_CONFIG, TemporalUnet, init_like_flax, load_lmpc, to_flax_params
from ..solvers import lqr_gains, lqr_solve
from ..train import Trainer
from ..utils.device import resolve_device
from . import lmpc_parity

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "chiprun_out" / "flagship_lmpc"
HORIZON, T, LR, BATCH, CHUNK = 8, 25, 3e-3, 512, 250
NOISE_STD = 0.15
INIT_SEED, DRAW_SEED, GRID_NOISE_SEED, TRACK_NOISE_SEED = 1, 2, 0, 1


def recipe_grid(n_grid: int = 15) -> np.ndarray:
    """(n_grid^2, 4): position over [-1, 1] by angle over [-pi/4, pi/4], velocities 0."""
    return np.array([[p, 0.0, t, 0.0] for p in np.linspace(-1, 1, n_grid)
                     for t in np.linspace(-np.pi / 4, np.pi / 4, n_grid)], np.float32)


def collect_recipe_dataset(device=None, n_grid: int = 15, n_noisy: int = 399,
                           n_track_steps: int = 50, n_track_noisy: int = 4
                           ) -> ControlSequenceDataset:
    """The LQR expert's dataset by the committed weights' recipe, on
    ``device`` (``cuda`` unless given): the grid and ``n_noisy`` replicas
    (``RandomState(0)`` standard normals times 0.15); the expert's
    ``n_track_steps``-step closed-loop states from every grid state, with
    the horizons solved there; ``n_track_noisy`` replicas of those states
    (``RandomState(1).normal(0, 0.15)``), solved. Concatenated in that order
    and fitted by limits, as the JAX package's ``from_arrays`` fits them."""
    dev = resolve_device(device)
    plant, cost = cartpole_lmpc(), cartpole_lmpc_cost()
    a, b, q, r, p = lmpc_parity.linear_matrices(plant, cost, dev)
    grid = recipe_grid(n_grid)
    noise = np.random.RandomState(GRID_NOISE_SEED).standard_normal((n_noisy,) + grid.shape)
    ds_grid = collect_lmpc_dataset(a, b, q, r, p, grid, HORIZON, NOISE_STD, n_noisy,
                                   noise=torch.from_numpy(noise.astype(np.float32)))
    ks = lqr_gains(a, b, q, r, p, HORIZON)
    x, xs, us = torch.from_numpy(grid).to(dev), [], []
    for _ in range(n_track_steps):
        u_seq = lqr_solve(a, b, q, r, p, x, HORIZON, gains=ks).us
        xs.append(x)
        us.append(u_seq)
        x = plant.step(x, u_seq[:, 0])
    x_cl = torch.stack(xs, dim=1).reshape(-1, 4).cpu().numpy()
    u_cl = torch.stack(us, dim=1).reshape(-1, HORIZON, 1)
    track_noise = np.random.RandomState(TRACK_NOISE_SEED).normal(
        0, NOISE_STD, (n_track_noisy,) + x_cl.shape)
    x_noisy = (x_cl[None] + track_noise).reshape(-1, 4).astype(np.float32)
    u_noisy = lqr_solve(a, b, q, r, p, torch.from_numpy(x_noisy).to(dev), HORIZON, gains=ks).us
    inputs = torch.cat([ds_grid.inputs, u_cl, u_noisy])
    condition = torch.cat([ds_grid.condition, torch.from_numpy(x_cl).to(dev),
                           torch.from_numpy(x_noisy).to(dev)])
    return ControlSequenceDataset.from_arrays(inputs, condition, device=dev)


def lmpc_model(device=None) -> TemporalUnet:
    """The recipe's denoiser, initialized as flax initializes it from ``RandomState(1)``."""
    model = TemporalUnet(**LMPC_CONFIG, cfg_indicator=True)
    return init_like_flax(model, np.random.RandomState(INIT_SEED)).to(resolve_device(device))


def limits(ds: ControlSequenceDataset) -> dict:
    """The dataset's normalizer limits as lists."""
    return {f"{field}_{k}": getattr(ds.normalizer.stats[field], k).tolist()
            for field in ("inputs", "condition") for k in ("mins", "maxs")}


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(OUT))
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--train-steps", type=int, default=230_000)
    p.add_argument("--batch-size", type=int, default=BATCH)
    p.add_argument("--chunk", type=int, default=CHUNK)
    p.add_argument("--grid", type=int, default=15, help="grid points per axis")
    p.add_argument("--noisy", type=int, default=399)
    p.add_argument("--track-steps", type=int, default=50)
    p.add_argument("--track-noisy", type=int, default=4)
    p.add_argument("--states", type=int, default=lmpc_parity.N_STATES)
    p.add_argument("--eval-steps", type=int, default=lmpc_parity.N_STEPS)
    p.add_argument("--log-every", type=int, default=10_000)
    args = p.parse_args(argv)
    n_chunks = max(1, args.train_steps // args.chunk)
    steps_run = n_chunks * args.chunk
    if steps_run % args.log_every or args.log_every % args.chunk:
        p.error("--log-every must be a multiple of --chunk and divide the steps run, so that the "
                "last chunk's mean loss is logged")
    dev = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    # 1. collect
    t0 = time.perf_counter()
    ds = collect_recipe_dataset(dev, args.grid, args.noisy, args.track_steps, args.track_noisy)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_collect = time.perf_counter() - t0
    ins, cond = lmpc_stats()
    print(f"[collect] {ds.n_init} LQR solves in {t_collect:.3f}s; limits {limits(ds)}; the "
          f"committed weights' (lmpc_stats) inputs {ins.mins.tolist()}..{ins.maxs.tolist()}, "
          f"condition {cond.mins.tolist()}..{cond.maxs.tolist()}", flush=True)
    ds.save(str(out / "dataset.npz"))

    # 2. train
    trainer = Trainer(GaussianDiffusion(make_schedule("exponential", T)), lmpc_model(dev), lr=LR,
                      checkpoint_dir=str(out / "checkpoints"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(DRAW_SEED)
    t0 = time.perf_counter()
    trainer.fit(ds, steps_run, args.batch_size, gen, chunk_size=args.chunk,
                steps_til_summary=args.log_every, steps_til_checkpoint=steps_run + 1)
    t_train = time.perf_counter() - t0
    final_loss = trainer.train_losses[-1][1]
    print(f"[train] {steps_run} steps in {t_train:.3f}s ({steps_run / t_train:.2f} steps/s); "
          f"the last chunk's mean loss {final_loss:.6f}", flush=True)
    pkl = out / "ema_params.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"ema_params": to_flax_params(trainer.ema_state_dict()), "step": steps_run,
                     "cfg_indicator": True, "horizon": HORIZON}, f)

    # 3. the parity evaluation on the trained EMA weights, reloaded from the pickle
    stats = (ds.normalizer.stats["inputs"], ds.normalizer.stats["condition"])
    par = lmpc_parity.run(dev, "episode", args.states, args.eval_steps, candidates=(1,),
                          model=load_lmpc(pkl, device=dev), stats=stats)
    report = {
        "device": par["device"], "n_samples": ds.n_init, "collect_s": t_collect,
        "train_steps": steps_run, "train_s": t_train, "steps_per_s": steps_run / t_train,
        "final_loss": final_loss, "eval_steps": args.eval_steps, "horizon": HORIZON,
        **{k: par[k] for k in lmpc_parity.KEYS}, "per_state_u_l1": par["per_state_u_l1"][1],
        "launches": par["launches"][1], "limits": limits(ds),
        "committed_weights_jax_cpu": dict(zip(lmpc_parity.KEYS[:4], LMPC_U_L1_SUMMARY)),
    }
    (out / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
