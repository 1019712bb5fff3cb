"""The flagship run on the card: collect the iLQR expert's closed-loop data,
train the flagship's denoiser on it, and evaluate the trained model against
the NMPC expert, the three steps of the JAX package's
``scripts/flagship_run.py`` (its ``--plant cartpole``; the other plants wait
for ROADMAP.md A5).

    python -m mpc_via_diffusion_model_tpu_torch.scripts.flagship_run [--train-steps 20000] \\
        [--out build/flagship_run] [--device cpu] [--collect-only] [--reuse]

1. Collect: ``collect_closed_loop_dataset`` over the flagship grid
   (``--grid-pos`` positions over [-1, 1] by ``--grid-theta`` angles over
   [3 pi / 4, 5 pi / 4]) times kicks +-5, ``--steps`` control steps of iLQR
   at ``--horizon`` (25 iterations) with ``--noisy`` replicas at 0.15, their
   normals from a ``torch.Generator`` seeded 0 on the device. The defaults
   are the flagship's sizes (352,000 samples, ``artifacts/flagship/report.json``).
   The nominal rows' limits are printed beside the JAX package's
   (``data/flagship_expert_yardstick.py``, (c)), the whole collection's beside
   ``data/flagship_stats.py``'s (the JAX package's collection on other
   draws).
2. Train: the flagship's ``TemporalUnet`` (``FLAGSHIP_CONFIG`` at
   ``--horizon``, the context-present bit), initialized by
   ``init_like_flax`` from ``RandomState(1)``, ``Trainer.fit`` in chunks of
   ``--chunk`` at ``--batch-size`` and lr 3e-3 on the exponential schedule
   of 25 steps, its draws from a ``torch.Generator`` seeded 2.
3. Evaluate: ``--seeds`` K = 1 closed loops of 80 replans from x0 = [0, 0,
   3.0, 0, theta*(3.0)] through the CFG episode kernel (one launch each, its
   plain version on the CPU) on the EMA weights and the collection's own
   statistics, each seed's noise one draw of a ``torch.Generator`` seeded
   with its index; the same noise through ``make_closed_loop`` with the CFG
   chain kernel, whose applied horizons give the horizon cost (its tracks
   within 1e-3 of the episode's); the port's NMPC expert
   (``make_nmpc_closed_loop``, 80 steps, kick 5), held beside the JAX
   package's (the yardstick's (a)); ``track_parity`` of seed 0 against the
   expert, ``per_step_mpc_costs`` and ``count_swing_modes``.

Writes into ``--out`` (never ``artifacts/flagship``, whose files are the
JAX package's record): ``dataset.npz``, ``checkpoints/final.ckpt`` (the JAX
package's checkpoint payload), ``ema_params.pkl`` (``{'ema_params', 'step',
'cfg_indicator'}``, the flax layout that ``models.load_flagship`` and the
JAX package read), the tracks as ``x_diffusion.npy``, ``u_diffusion.npy``,
``x_mpc.npy``, ``u_mpc.npy``, and ``report.json`` with the JAX script's
keys and the port's own beside them. Left out of the JAX script: its
``args.yaml`` (PyYAML) and its tracer (both ROADMAP.md A8), its comparison
plot (matplotlib) and the other plants' grids and cross-checks (A5, A6).
"""
from __future__ import annotations

import argparse
import json
import pickle
import time
import types
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..control import (count_swing_modes, make_closed_loop, make_nmpc_closed_loop,
                       per_step_mpc_costs, track_parity)
from ..core import make_schedule
from ..data import flagship_expert_yardstick as ys
from ..data.datasets import ControlSequenceDataset
from ..data.flagship_stats import flagship_stats
from ..data.generation import collect_closed_loop_dataset
from ..data.normalization import fit_normalizer
from ..diffusion import GaussianDiffusion
from ..dynamics import cartpole_virtual_cost, cartpole_virtual_swingup
from ..models import FLAGSHIP_CONFIG, TemporalUnet, init_like_flax, to_flax_params
from ..ops.fused_denoise import make_fused_cfg_chain
from ..ops.fused_episode import make_fused_cfg_episode
from ..solvers import ILQRConfig
from ..train import Trainer, load_checkpoint
from ..utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "flagship_run"
T, N_TAIL, W, LR, ITERATIONS, NOISE_STD = 25, 5, 0.01, 3e-3, 25, 0.15
N_EVAL_STEPS, TRACK_TOL = 80, 1e-3
COLLECT_SEED, INIT_SEED, DRAW_SEED = 0, 1, 2


def limits(stats_in, stats_cond) -> dict:
    """Normalizer limits as lists, under the yardstick's names."""
    return {f"{field}_{k}": getattr(st, k).tolist()
            for field, st in (("inputs", stats_in), ("condition", stats_cond))
            for k in ("mins", "maxs")}


def collect(args, dev) -> ControlSequenceDataset:
    grid = ys.flagship_grid(args.grid_pos, args.grid_theta)
    return collect_closed_loop_dataset(
        cartpole_virtual_swingup(), cartpole_virtual_cost(), grid, horizon=args.horizon,
        n_control_steps=args.steps, solver_iterations=ITERATIONS, u_kick_scales=ys.KICKS,
        noise_std=NOISE_STD, n_noisy=args.noisy,
        generator=torch.Generator(device=dev).manual_seed(COLLECT_SEED), device=dev)


def flagship_model(horizon: int, device=None) -> TemporalUnet:
    """The flagship's denoiser at ``horizon``, initialized as flax initializes it from ``RandomState(1)``."""
    model = TemporalUnet(**dict(FLAGSHIP_CONFIG, n_support_points=horizon), cfg_indicator=True)
    return init_like_flax(model, np.random.RandomState(INIT_SEED)).to(resolve_device(device))


def evaluate(model, ds, horizon: int, n_seeds: int, dev, n_steps: int = N_EVAL_STEPS) -> dict:
    """Step 3: the episodes, the chain loops on the same noise, the expert and the metrics."""
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_cost()
    schedule = make_schedule("exponential", T)
    ins, cond = ds.normalizer.stats["inputs"], ds.normalizer.stats["condition"]
    ep = make_fused_cfg_episode(model, schedule, ins, cond, plant, cost, n_steps=n_steps, w=W,
                                n_diffusion_steps_without_noise=N_TAIL, device=dev)
    chain = make_fused_cfg_chain(ep.packed, schedule, n_samples=1, w=W, n_tail=N_TAIL, device=dev)
    loop = make_closed_loop(GaussianDiffusion(schedule), model, ins, cond, plant, cost,
                            horizon=horizon, n_steps=n_steps, w=W,
                            n_diffusion_steps_without_noise=N_TAIL, sample_override=chain,
                            device=dev)
    x0 = torch.tensor(ys.EXPERT_X0, device=dev)
    runs, horizon_costs, route_err = [], [], 0.0
    for seed in range(n_seeds):
        noise = torch.randn(ep.noise_shape, generator=torch.Generator(device=dev).manual_seed(seed),
                            device=dev)
        x_tr, u_tr, costs = ep(x0, noise)
        via_chain = loop(x0, noise=noise)
        for got, want in ((via_chain.x_track, x_tr), (via_chain.u_track, u_tr)):
            torch.testing.assert_close(got, want, atol=TRACK_TOL, rtol=TRACK_TOL)
            route_err = max(route_err, (got - want).abs().max().item())
        runs.append((x_tr, u_tr, costs))
        horizon_costs.append(per_step_mpc_costs(plant, cost.to(dev), via_chain).double().sum().item())
    cfg = ILQRConfig(horizon=horizon, n_iterations=ITERATIONS)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    expert = make_nmpc_closed_loop(plant, cost, cfg, n_steps=n_steps, u_init_scale=ys.KICKS[0],
                                   device=dev)(x0)
    expert_cost = expert.stage_costs.double().sum().item()
    expert_s = time.perf_counter() - t0
    closed = [c.double().sum().item() for _, _, c in runs]
    one = types.SimpleNamespace(x_track=runs[0][0], u_track=runs[0][1])
    out = {
        "parity": track_parity(one, expert),
        "closed_loop_cost_diffusion_mean10": float(np.mean(closed)),
        "closed_loop_cost_nmpc": expert_cost,
        "horizon_cost_diffusion_mean10": float(np.mean(horizon_costs)),
        "horizon_cost_nmpc": per_step_mpc_costs(plant, cost.to(dev), expert).double().sum().item(),
        "modality": count_swing_modes(torch.stack([x for x, _, _ in runs])),
        "closed_loop_costs_diffusion": closed,
        "cost_over_expert": float(np.mean(closed)) / expert_cost,
        "episode_launches": ep.launches, "chain_launches": chain.launches,
        "chain_route_max_abs_err": route_err, "expert_seconds": expert_s,
        "expert_ms_per_step": 1e3 * expert_s / n_steps,
        "tracks": {"x_diffusion": torch.stack([x for x, _, _ in runs]),
                   "u_diffusion": torch.stack([u for _, u, _ in runs]),
                   "x_mpc": expert.x_track, "u_mpc": expert.u_track}}
    if (horizon, n_steps) == (ys.HORIZON, ys.N_STEPS):
        out["expert_vs_jax"] = {"cost_jax": ys.EXPERT_COST, **ys.expert_gaps(expert, n_steps),
                                "bounds": dict(zip(("cost_rel", "u_max", "x_max"),
                                                   ys.EXPERT_BOUNDS[n_steps]))}
    return out


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(OUT))
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--grid-pos", type=int, default=ys.GRID_POS)
    p.add_argument("--grid-theta", type=int, default=ys.GRID_THETA)
    p.add_argument("--steps", type=int, default=ys.N_STEPS, help="closed-loop collection steps")
    p.add_argument("--noisy", type=int, default=10)
    p.add_argument("--horizon", type=int, default=ys.HORIZON)
    p.add_argument("--train-steps", type=int, default=20_000)
    p.add_argument("--chunk", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--seeds", type=int, default=10, help="evaluation loops")
    p.add_argument("--eval-steps", type=int, default=N_EVAL_STEPS)
    p.add_argument("--reuse", action="store_true",
                   help="load dataset.npz and checkpoints/final.ckpt from --out where they exist")
    p.add_argument("--collect-only", action="store_true",
                   help="write dataset.npz and stop before training")
    args = p.parse_args(argv)
    out = Path(args.out).resolve()
    if out == (ROOT / "artifacts" / "flagship").resolve():
        p.error("--out artifacts/flagship would overwrite the JAX package's record")
    n_chunks = max(1, args.train_steps // args.chunk)
    steps_run = n_chunks * args.chunk
    dev = resolve_device(args.device)
    out.mkdir(parents=True, exist_ok=True)
    ds_path, ckpt_path = out / "dataset.npz", out / "checkpoints" / "final.ckpt"
    reuse = args.reuse and ds_path.exists()
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" else (lambda: None)
    report = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}

    # 1. collect
    if reuse:
        ds, t_collect = ControlSequenceDataset.load(str(ds_path), device=dev), None
        print(f"[collect] reused {ds.n_init} samples from {ds_path}", flush=True)
    else:
        sync()
        t0 = time.perf_counter()
        ds = collect(args, dev)
        sync()
        t_collect = time.perf_counter() - t0
        ds.save(str(ds_path))
    n_groups = args.grid_pos * args.grid_theta * len(ys.KICKS)
    n_solves, n_nominal = n_groups * args.steps * (1 + args.noisy), n_groups * args.steps
    stats = ds.normalizer.stats
    report.update({
        "n_samples": ds.n_init, "collect_seconds": t_collect,
        "solves_per_second": n_solves / t_collect if t_collect else None,
        "solver_converged_fraction": ds.solver_converged_fraction,
        "limits": limits(stats["inputs"], stats["condition"]),
        "limits_flagship_stats": limits(*flagship_stats())})
    if ds.n_init == n_solves:  # nothing dropped: the first rows are the nominal solves
        report["nominal_limits"] = limits(fit_normalizer(ds.inputs[:n_nominal].cpu().numpy()),
                                          fit_normalizer(ds.condition[:n_nominal].cpu().numpy()))
        if (args.grid_pos, args.grid_theta, args.steps, args.horizon) == (
                ys.GRID_POS, ys.GRID_THETA, ys.N_STEPS, ys.HORIZON):
            report["nominal_limits_jax"] = {k: list(getattr(ys, f"NOMINAL_{k.upper()}"))
                                            for k in report["nominal_limits"]}
    print(f"[collect] {ds.n_init} samples ({n_solves} iLQR solves) in {t_collect}s; converged "
          f"fraction {ds.solver_converged_fraction}; limits {report['limits']}; nominal limits "
          f"{report.get('nominal_limits')} (JAX on the CPU {report.get('nominal_limits_jax')})",
          flush=True)
    if args.collect_only:
        (out / "report.json").write_text(json.dumps(report, indent=2))
        print(json.dumps(report), flush=True)
        return report

    # 2. train
    trainer = Trainer(GaussianDiffusion(make_schedule("exponential", T)),
                      flagship_model(args.horizon, dev), lr=LR,
                      checkpoint_dir=str(out / "checkpoints"), device=dev)
    if reuse and ckpt_path.exists():
        trainer.state, _ = load_checkpoint(str(ckpt_path), trainer.state.layout, dev)
        t_train, final_loss = None, None
        print(f"[train] reused {ckpt_path}", flush=True)
    else:
        sync()
        t0 = time.perf_counter()
        trainer.fit(ds, steps_run, args.batch_size,
                    torch.Generator(device=dev).manual_seed(DRAW_SEED), chunk_size=args.chunk,
                    steps_til_summary=max(args.chunk, steps_run // 10 // args.chunk * args.chunk),
                    steps_til_checkpoint=steps_run + 1)
        sync()
        t_train = time.perf_counter() - t0
        final_loss = trainer.train_losses[-1][1]
        print(f"[train] {steps_run} steps in {t_train:.3f}s ({steps_run / t_train:.2f} steps/s)",
              flush=True)
    with open(out / "ema_params.pkl", "wb") as f:
        pickle.dump({"ema_params": to_flax_params(trainer.ema_state_dict()),
                     "step": int(trainer.state.step), "cfg_indicator": True}, f)
    report.update({"train_steps": int(trainer.state.step), "train_seconds": t_train,
                   "train_steps_per_second": steps_run / t_train if t_train else None,
                   "final_loss": final_loss})

    # 3. evaluate on the EMA weights
    model = TemporalUnet(**dict(FLAGSHIP_CONFIG, n_support_points=args.horizon), cfg_indicator=True)
    model.load_state_dict(trainer.ema_state_dict())
    ev = evaluate(model.to(dev).eval(), ds, args.horizon, args.seeds, dev, args.eval_steps)
    for name, track in ev.pop("tracks").items():
        np.save(out / f"{name}.npy", track.cpu().numpy())
    report.update(ev)
    (out / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
