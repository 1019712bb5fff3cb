"""Progressive distillation of the flagship's CFG cart-pole teacher on the
card: the JAX package's ``scripts/distill_flagship.py``, in the port.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.distill_flagship \\
        [--teacher artifacts/flagship_modality] [--out build/distill_flagship] \\
        [--steps-per-round 30000] [--rounds 3] [--collect] [--device cpu]

The teacher (``--teacher``'s ``ema_params.pkl``: the 25-step CFG
``TemporalUnet`` at horizon 64, two U-Net passes per step) is distilled
into conditional-only DDIM students of 12, 6 and 3 U-Net passes, the
guidance weight baked in by the first round (``diffusion/distillation.py``).

1. Data: the teacher directory's ``dataset.npz`` where it has one (its own
   limits). Otherwise ``--collect`` runs the collection of the JAX package's
   ``scripts/flagship_modality.py``: grid ``--grid-pos`` positions over
   [-0.5, 0.5] by ``--grid-theta`` angles over [3 pi / 4, 5 pi / 4], kicks
   +-5, ``--collect-steps`` cold-started iLQR steps at the horizon (25
   iterations) with ``--noisy`` replicas at 0.15 from a ``torch.Generator``
   seeded 0, under the collection cost (184,800 samples at the defaults),
   written to ``--out/dataset.npz``. It is normalized with
   ``teacher_stats()``, the limits the teacher was trained on; its own
   limits are printed beside them. ``--reuse`` loads ``--out/dataset.npz``;
   ``--collect-only`` stops after it.
2. The expert: the port's ``make_nmpc_closed_loop`` (25 iterations, kick
   5, no warm start, ``--eval-steps`` steps) from x0 = [0, 0, 3.0, 0,
   theta*(3.0)], its cost beside the JAX package's on the CPU
   (``data/distill_yardstick.py`` (b)).
3. The teacher's baseline: ``--eval-seeds`` closed loops through the CFG
   episode kernel (25 + 5 steps, w), each seed's noise one draw of a
   ``torch.Generator`` seeded with its index (skipped on ``--init-student``).
4. The rounds: each halves the grid, starting from ``ddim_time_grid(25,
   t_start=23)`` (or ``--init-times`` with ``--init-student``); the student
   starts as its teacher and trains ``--steps-per-round`` steps in chunks
   of ``--chunk`` (``make_distill_step`` under ``make_scanned_train_steps``,
   lr ``--lr`` with the clip at 1, draws from a ``torch.Generator`` seeded
   20 + round); CFG only in the first round of a run from the teacher. Its
   EMA is saved as ``student_{n}eval.pkl`` (``{'params'}``, the flax layout
   the JAX package pickles and ``models.load_student`` reads) and evaluated
   through the DDIM episode kernel at K = 1 over ``--eval-seeds``, each
   seed's noise drawn as in step 3; it is the next round's teacher.

``report.json`` has the JAX script's keys, and beside them the route of each
evaluation (``kernel``), its launches and the port's times. ``--out`` may
not lie under ``artifacts/``, the JAX package's record.
"""
from __future__ import annotations

import argparse
import json
import pickle
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..control import make_nmpc_closed_loop
from ..core import make_schedule
from ..data import distill_yardstick as dys
from ..data.datasets import ControlSequenceDataset
from ..data.flagship_expert_yardstick import expert_gaps
from ..data.generation import collect_closed_loop_dataset, make_initial_state_grid
from ..data.normalization import DatasetNormalizer, normalize
from ..data.teacher_stats import teacher_stats
from ..diffusion import ddim_time_grid, make_distill_step
from ..dynamics import (cartpole_virtual_collect_cost, cartpole_virtual_swingup,
                        theta_to_red_theta)
from ..models import FLAGSHIP_CONFIG, TemporalUnet, from_flax_params, to_flax_params
from ..ops.fused_episode import make_fused_cfg_episode, make_fused_ddim_episode
from ..solvers import ILQRConfig
from ..train import ParamLayout, TrainState, make_optimizer, make_scanned_train_steps
from ..utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "distill_flagship"
T, N_TAIL, ITERATIONS, NOISE_STD, KICKS = 25, 5, 25, 0.15, (5.0, -5.0)
COLLECT_SEED, ROUND_SEED = 0, 20


def collect(args, dev) -> ControlSequenceDataset:
    """The modality collection, normalized with the teacher's limits."""
    grid = make_initial_state_grid(np.linspace(-0.5, 0.5, args.grid_pos),
                                   np.linspace(3 * np.pi / 4, 5 * np.pi / 4, args.grid_theta),
                                   state_dim=5, theta_to_virtual=theta_to_red_theta)
    ds = collect_closed_loop_dataset(
        cartpole_virtual_swingup(), cartpole_virtual_collect_cost(), grid, horizon=args.horizon,
        n_control_steps=args.collect_steps, solver_iterations=ITERATIONS, u_kick_scales=KICKS,
        noise_std=NOISE_STD, n_noisy=args.noisy, cold_start=True,
        generator=torch.Generator(device=dev).manual_seed(COLLECT_SEED), device=dev)
    return ds


def with_stats(ds: ControlSequenceDataset, ins, cond) -> ControlSequenceDataset:
    """``ds`` normalized with the given limits in place of its own."""
    ins, cond = ins.to(ds.device), cond.to(ds.device)
    return ControlSequenceDataset(
        ds.inputs, ds.condition, normalize(ins, ds.inputs), normalize(cond, ds.condition),
        DatasetNormalizer({"inputs": ins.to("cpu"), "condition": cond.to("cpu")}),
        ds.solver_converged_fraction)


def limits(stats_in, stats_cond) -> dict:
    return {f"{field}_{k}": getattr(st, k).tolist()
            for field, st in (("inputs", stats_in), ("condition", stats_cond))
            for k in ("mins", "maxs")}


def unet(horizon: int, flax_params, device) -> TemporalUnet:
    """The flagship's architecture at ``horizon`` with the context-present bit, on ``device``."""
    model = TemporalUnet(**dict(FLAGSHIP_CONFIG, n_support_points=horizon), cfg_indicator=True)
    model.load_state_dict(from_flax_params(flax_params))
    return model.to(device).eval()


def seeded_noise(shape, seed: int, dev) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--teacher", default=str(ROOT / "artifacts" / "flagship_modality"))
    p.add_argument("--out", default=str(OUT))
    p.add_argument("--horizon", type=int, default=64,
                   help="must match the teacher's n_support_points")
    p.add_argument("--w", type=float, default=0.01)
    p.add_argument("--steps-per-round", type=int, default=30000)
    p.add_argument("--chunk", type=int, default=250)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--eval-seeds", type=int, default=10)
    p.add_argument("--eval-steps", type=int, default=80, help="closed-loop steps of every evaluation")
    p.add_argument("--init-student", default=None,
                   help="resume from a saved student .pkl (skips earlier rounds); requires "
                        "--init-times")
    p.add_argument("--init-times", default=None,
                   help="comma-separated DDIM grid of --init-student, e.g. '23,15,7'")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--collect", action="store_true",
                   help="collect the teacher's dataset when its directory has none")
    p.add_argument("--collect-only", action="store_true", help="stop after the data")
    p.add_argument("--reuse", action="store_true", help="load --out/dataset.npz where it exists")
    p.add_argument("--grid-pos", type=int, default=5)
    p.add_argument("--grid-theta", type=int, default=21)
    p.add_argument("--collect-steps", type=int, default=80)
    p.add_argument("--noisy", type=int, default=10)
    args = p.parse_args(argv)
    if (args.init_student is None) != (args.init_times is None):
        p.error("--init-student and --init-times must be given together")
    out = Path(args.out).resolve()
    if (ROOT / "artifacts").resolve() in (out, *out.parents):
        p.error("--out may not lie under artifacts/: its files are the JAX package's record")
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out.mkdir(parents=True, exist_ok=True)
    teacher_dir = Path(args.teacher)
    report = {"teacher": args.teacher, "device": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu"}

    # 1. data
    t_ins, t_cond = teacher_stats()
    ds_out = out / "dataset.npz"
    if args.reuse and ds_out.exists():
        ds = with_stats(ControlSequenceDataset.load(str(ds_out), device=dev), t_ins, t_cond)
        report["data"] = {"source": str(ds_out), "n_samples": ds.n_init}
    elif (teacher_dir / "dataset.npz").exists():
        ds = ControlSequenceDataset.load(str(teacher_dir / "dataset.npz"), device=dev)
        report["data"] = {"source": str(teacher_dir / "dataset.npz"), "n_samples": ds.n_init}
    elif args.collect:
        sync()
        t0 = time.perf_counter()
        own = collect(args, dev)
        sync()
        t_collect = time.perf_counter() - t0
        own.save(str(ds_out))
        st = own.normalizer.stats
        n_solves = args.grid_pos * args.grid_theta * len(KICKS) * args.collect_steps * (1 + args.noisy)
        report["data"] = {"source": "collected", "n_samples": own.n_init,
                          "collect_seconds": t_collect, "solves_per_second": n_solves / t_collect,
                          "solver_converged_fraction": own.solver_converged_fraction,
                          "limits": limits(st["inputs"], st["condition"]),
                          "limits_teacher_stats": limits(t_ins, t_cond)}
        print(f"[collect] {own.n_init} samples ({n_solves} iLQR solves) in {t_collect:.3f}s; "
              f"converged fraction {own.solver_converged_fraction}; limits "
              f"{report['data']['limits']}; the teacher's (normalizing with these) "
              f"{report['data']['limits_teacher_stats']}", flush=True)
        ds = with_stats(own, t_ins, t_cond)
    else:
        p.error(f"{teacher_dir} has no dataset.npz: pass --collect (or --reuse with --out's)")
    if args.collect_only:
        (out / "report.json").write_text(json.dumps(report, indent=2))
        print(json.dumps(report), flush=True)
        return report
    ins, cond = ds.normalizer.stats["inputs"], ds.normalizer.stats["condition"]
    with open(teacher_dir / "ema_params.pkl", "rb") as f:
        teacher_flax = pickle.load(f)

    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_collect_cost()
    schedule = make_schedule("exponential", T)
    x0 = torch.tensor(dys.X0, device=dev)

    # 2. the expert
    sync()
    t0 = time.perf_counter()
    expert = make_nmpc_closed_loop(plant, cost, ILQRConfig(horizon=args.horizon,
                                                           n_iterations=ITERATIONS),
                                   n_steps=args.eval_steps, u_init_scale=dys.EXPERT_KICK,
                                   warm_start=False, device=dev)(x0)
    sync()
    expert_s = time.perf_counter() - t0
    expert_cost = expert.stage_costs.double().sum().item()
    report.update({"expert_cost": expert_cost, "expert_seconds": expert_s})
    if (args.horizon, args.eval_steps) == (dys.HORIZON, dys.N_EXPERT_STEPS):
        report["expert_vs_jax"] = {"cost_jax": dys.EXPERT_COST,
                                   **expert_gaps(expert, args.eval_steps, dys.expert_tracks())}
    print(f"[expert] closed-loop cost {expert_cost:.3f} in {expert_s:.3f}s (the JAX package's "
          f"on the CPU {dys.EXPERT_COST:.3f}; {report.get('expert_vs_jax')})", flush=True)

    def evaluate(kernel_episode) -> dict:
        costs = []
        for seed in range(args.eval_seeds):
            _, _, c = kernel_episode(x0, seeded_noise(kernel_episode.noise_shape, seed, dev))
            costs.append(c.double().sum().item())
        return {"cost_mean": float(np.mean(costs)), "cost_min": float(np.min(costs)),
                "cost_max": float(np.max(costs)), "costs": costs,
                "launches": kernel_episode.launches, "plain_calls": kernel_episode.plain_calls}

    # 3. the teacher's baseline through the CFG episode kernel
    teacher_cost = None
    if args.init_student is None:
        ep = make_fused_cfg_episode(unet(args.horizon, teacher_flax, dev), schedule, ins, cond,
                                    plant, cost, n_steps=args.eval_steps, w=args.w,
                                    n_diffusion_steps_without_noise=N_TAIL, device=dev)
        sync()
        t0 = time.perf_counter()
        ev = evaluate(ep)
        sync()
        teacher_cost = ev["cost_mean"]
        report["teacher_eval"] = {"kernel": "cfg_episode", "seconds": time.perf_counter() - t0,
                                  **ev}
        print(f"[teacher] closed-loop cost {teacher_cost:.3f} ({teacher_cost / expert_cost:.4f}x "
              f"expert) through cfg_episode: {ev}", flush=True)
    report.update({"teacher_cost": teacher_cost, "w": args.w, "rounds": []})

    # 4. the rounds
    times = ddim_time_grid(T, t_start=23)
    cur = teacher_flax
    if args.init_student is not None:
        with open(args.init_student, "rb") as f:
            cur = pickle.load(f)
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
        model = unet(args.horizon, cur, dev)
        layout = ParamLayout.of(model)
        teacher_params = {n: p.detach() for n, p in model.named_parameters()}
        step_fn, student_times = make_distill_step(
            schedule, model, optimizer, teacher_params, times, w=args.w,
            teacher_cfg=(r == 0 and args.init_student is None))
        chunk = make_scanned_train_steps(step_fn, args.chunk)
        params = layout.flatten(teacher_params)
        state = TrainState(params, params.clone(), optimizer.init(params),
                           torch.zeros((), dtype=torch.int32, device=dev), layout)
        gen = torch.Generator(device=dev).manual_seed(ROUND_SEED + r)
        losses, skipped = [], 0
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
        sep = make_fused_ddim_episode(unet(args.horizon, student, dev), schedule, student_times,
                                      ins, cond, plant, cost, n_steps=args.eval_steps, device=dev)
        ev = evaluate(sep)
        steps = n_chunks * args.chunk
        rec = {"n_evals": len(student_times), "times": [int(t) for t in student_times],
               "train_seconds": t_train, "final_loss": losses[-1] if losses else None,
               "cost_mean": ev["cost_mean"], "cost_min": ev["cost_min"],
               "cost_max": ev["cost_max"], "cost_ratio_vs_expert": ev["cost_mean"] / expert_cost,
               "kernel": "ddim_episode", "steps": steps,
               "steps_per_second": steps / t_train if t_train > 0 else None,
               "ms_per_step": 1e3 * t_train / steps if steps else None,
               "teacher_cfg": r == 0 and args.init_student is None,
               "costs": ev["costs"], "launches": ev["launches"],
               "plain_calls": ev["plain_calls"], "chunk_last_losses": losses}
        report["rounds"].append(rec)
        print(f"[round {r}] {len(student_times)}-eval student: cost {ev['cost_mean']:.3f} "
              f"({rec['cost_ratio_vs_expert']:.4f}x expert) through ddim_episode "
              f"({ev['launches']} launches); {steps} steps in {t_train:.3f}s", flush=True)
        cur, times = student, student_times

    (out / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
