"""The high-dimensional workloads on the card: the port of the JAX package's
``scripts/bench_highdim.py``, its rows and JSON keys, plus ``--device``.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.bench_highdim [--steps 80] \\
        [--sustained-steps 400] [--rate-episodes 8] [--rate-batches 3] [--sustained-reps 3] \\
        [--skip-quadrotor] [--skip-guided-sustained] [--device cuda] [--out PATH]

The panda arm (``panda_rbd``: horizon 128, 7 control channels, the 20-dim
``make_panda_context``) runs its CFG teacher
(``artifacts/flagship_panda_rbd/ema_params.pkl``, the statistics of
``data/panda_stats.py``: the JAX script's real weights) from x0 = 0.3 rad on
every joint at rest, T = 25 + 5, w = 0.01, K = 1. Its rows, one JSON line
each:

- ``panda_rbd_closed_loop_hz_xla`` and ``panda_rbd_sustained_hz_xla``: the
  loop on the plain ``TemporalUnet`` (the port's stand-in for the JAX
  script's XLA loop): pipelined (``--rate-episodes`` episodes of
  ``--steps`` replans issued back to back, best of ``--rate-batches``) and
  sustained (one ``--sustained-steps`` episode, best of
  ``--sustained-reps`` after a warm-up);
- ``panda_rbd_fused_chain_hz_{fp32,bf16}``: ``make_closed_loop`` with the
  CFG chain kernel (``cfg_chain_turns``, ``cfg_chain_turns_bf16``: the plan
  in turns) as ``sample_override`` and the arm stepped in torch, pipelined;
- ``panda_rbd_whole_episode_kernel_hz``: the CFG episode kernel's panda
  entry with the in-kernel draw (``cfg_episode_panda_draw``: the teacher,
  the context map, ``PandaRbd`` and the Philox draw in one launch per
  episode), sustained, with ``pipelined`` beside it.

The chain rows and the episode row also carry ``cost_mean10``: the mean of
the protocol's 10 episodes' summed stage costs (the chain rows' 10 as one
batched loop on staged draws from ``torch.Generator(device).manual_seed(7)``,
the episode row's on the seeds ``seed_from_generator(manual_seed(7000 +
i))``), with ``within_yardstick``, whether it lies within
``data/panda_teacher_yardstick.py``'s bounds of the JAX package's on the CPU
(``chain`` or ``episode``; null unless ``--steps`` is the protocol's 80).
The script exits non-zero when an fp32 row's mean does not.

The quadrotor (horizon 48, 4 channels, the 12-state as context) runs its
flagship teacher (``artifacts/flagship_quadrotor/ema_params.pkl``, the
statistics of ``data/quadrotor_stats.py``) from x0 = (2.6, 0.5, 1.0, 0...),
the task cost of ``scripts/quadrotor_task.py``, 60 replans, unguided and
guided by the obstacles' cost gradient (guide scale 0.1, one guide step
from t = 12.5): ``quadrotor_closed_loop_hz_{unguided,guided}`` pipelined,
and ``quadrotor_sustained_hz_guided`` (``--skip-guided-sustained`` leaves it
out: at about 0.4 guided replans per second on an H100, 400 replans take
about 16 minutes).

Every line carries the card's name and power limit (``nvidia-smi``); no TPU
number is a target. The report goes to ``--out``
(``chiprun_out/bench_highdim.json`` by default), never under
``artifacts/``. ``--device cpu`` runs every row through the plain versions,
for a test at a tiny ``--steps``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..control.runtime import make_closed_loop
from ..core.schedules import make_schedule
from ..data import guided_yardstick as gys
from ..data import panda_teacher_yardstick as tys
from ..data.panda_stats import panda_stats
from ..data.quadrotor_stats import quadrotor_stats
from ..diffusion.gaussian_diffusion import GaussianDiffusion
from ..dynamics import get_plant
from ..dynamics.arm import make_panda_context, panda_cost, panda_rbd, panda_rbd_unrolled
from ..eval.timing import pipelined_time_fn
from ..models.weights import load_panda_teacher, load_quadrotor_teacher
from ..ops import philox
from ..ops.fused_denoise import make_fused_cfg_chain
from ..ops.fused_episode import make_fused_cfg_episode
from ..utils.device import resolve_device
from .quadrotor_task import make_loop_guide_builder, make_task_cost

__all__ = ["panda_chain_loop", "panda_episode", "draw_seeds", "main"]

ROOT = Path(__file__).resolve().parents[2]
Q_STEPS, Q_X0 = 60, (2.6, 0.5, 1.0) + (0.0,) * 9


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_of(fn, n: int) -> float:
    """Seconds of the fastest of ``n`` synchronised calls, after a warm-up."""
    fn()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def panda_chain_loop(teacher, n_steps: int, n_starts: int, dev, sample_override=None):
    """The teacher's CFG loop over ``n_starts`` states with ``panda_rbd``
    stepped in torch: the plain chain unless ``sample_override`` (a CFG chain
    kernel of ``n_starts`` samples) is given."""
    return make_closed_loop(GaussianDiffusion(make_schedule("exponential", tys.T)), teacher,
                            *(st.to(dev) for st in panda_stats()), panda_rbd(), panda_cost(),
                            horizon=tys.H, n_steps=n_steps, w=tys.W,
                            n_diffusion_steps_without_noise=tys.N_TAIL,
                            state_to_condition=make_panda_context(),
                            sample_override=sample_override, device=dev)


def panda_chain(teacher, n_samples: int, dev, weights_dtype=torch.float32):
    """Kernel 1 on the teacher for ``n_samples`` samples (its plan in turns)."""
    return make_fused_cfg_chain(teacher, make_schedule("exponential", tys.T), n_samples=n_samples,
                                w=tys.W, n_tail=tys.N_TAIL, weights_dtype=weights_dtype,
                                device=dev)


def panda_episode(teacher, n_steps: int, dev):
    """Kernel 3's panda entry on the teacher at K = 1 with the in-kernel draw:
    ``episode(x0 (14,), seed (2,) int32)``; its plain version steps
    ``panda_rbd_unrolled`` on the draw's table."""
    ins, cond = (st.to(dev) for st in panda_stats())
    return make_fused_cfg_episode(teacher, make_schedule("exponential", tys.T), ins, cond,
                                  panda_rbd_unrolled(), panda_cost(), n_steps=n_steps, w=tys.W,
                                  n_diffusion_steps_without_noise=tys.N_TAIL,
                                  state_to_condition=make_panda_context(),
                                  inkernel_noise=True, device=dev)


def draw_seeds(n: int, base: int, dev) -> list:
    """``n`` episode seeds, (2,) int32 each: ``seed_from_generator`` of
    ``torch.Generator().manual_seed(base + i)``."""
    return [philox.seed_from_generator(torch.Generator().manual_seed(base + i)).to(dev)
            for i in range(n)]


def staged(n: int, n_steps: int, dev, seed: int) -> torch.Tensor:
    """(n, n_steps, 31, 1, 128, 7): n episodes' staged CFG draws."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, n_steps, tys.T + tys.N_TAIL + 1, 1, tys.H, 7), generator=gen,
                       device=dev)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=tys.N_STEPS)
    p.add_argument("--sustained-steps", type=int, default=400)
    p.add_argument("--rate-episodes", type=int, default=8)
    p.add_argument("--rate-batches", type=int, default=3)
    p.add_argument("--sustained-reps", type=int, default=3)
    p.add_argument("--skip-quadrotor", action="store_true")
    p.add_argument("--skip-guided-sustained", action="store_true")
    p.add_argument("--device", default=None, help="cuda unless given")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "bench_highdim.json"))
    args = p.parse_args(argv)
    out_path = Path(args.out).resolve()
    if (ROOT / "artifacts") in out_path.parents:
        raise SystemExit(f"--out {args.out}: the report goes under chiprun_out/, not artifacts/")
    dev = resolve_device(args.device)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout.strip()
            if dev.type == "cuda" else "cpu")
    n, n_rate = tys.N_SEEDS, args.rate_episodes
    protocol = args.steps == tys.N_STEPS
    rows, failed = [], []

    def emit(metric: str, value, **extra) -> dict:
        row = {"metric": metric, "value": value, "unit": "Hz", "real_weights": True, **extra,
               "device": str(dev), "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
        return row

    def cost_fields(row: str, costs, gate: bool) -> dict:
        costs = [float(c) for c in costs]
        within = tys.within(row, costs) if protocol else None
        if gate and within is False:
            failed.append(row)
        return {"cost_mean10": float(np.mean(costs)), "costs": costs,
                "within_yardstick": within,
                "yardstick_gaps": tys.gaps(row, costs) if protocol else None}

    # ---- the panda arm's CFG teacher ----
    teacher = load_panda_teacher(tys.TEACHER, device=dev)
    x0 = torch.from_numpy(tys.x0()).to(dev)
    rate_noise = staged(n_rate, args.steps, dev, 3)
    rate_args = [(x0, rate_noise[i]) for i in range(n_rate)]
    long_noise = staged(1, args.sustained_steps, dev, 9)[0]
    cfg = {"config": "H=128 ch=7 ctx=20 CFG 25+5", "n_steps": args.steps}
    loop = panda_chain_loop(teacher, args.steps, 1, dev)
    dt = pipelined_time_fn(lambda x, z: loop(x, z).x_track, rate_args, args.rate_batches)
    emit("panda_rbd_closed_loop_hz_xla", args.steps / dt, **cfg,
         note="the plain TemporalUnet loop, standing in for the JAX script's XLA loop")
    long = panda_chain_loop(teacher, args.sustained_steps, 1, dev)
    dt = _best_of(lambda: (long(x0, long_noise), _sync(dev)), args.sustained_reps)
    emit("panda_rbd_sustained_hz_xla", args.sustained_steps / dt,
         sustained_steps=args.sustained_steps)
    for wd, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        chain = panda_chain(teacher, n, dev, wd)
        costs = panda_chain_loop(teacher, args.steps, n, dev, chain)(
            x0.expand(n, 14), staged(n, args.steps, dev, 7)).stage_costs.double().sum(-1)
        one = panda_chain(teacher, 1, dev, wd)
        loop = panda_chain_loop(teacher, args.steps, 1, dev, one)
        one.launches = 0
        dt = pipelined_time_fn(lambda x, z: loop(x, z).x_track, rate_args, args.rate_batches)
        emit(f"panda_rbd_fused_chain_hz_{tag}", args.steps / dt, **cfg, entry=one.entry,
             plan=one.plan, smem_bytes=one.smem_bytes, launches=one.launches,
             **cost_fields("chain", costs.tolist(), tag == "fp32"),
             note="CFG chain kernel per replan (in turns), the arm stepped in torch")
    ep = panda_episode(teacher, args.steps, dev)
    costs = [ep(x0, s)[2].double().sum() for s in draw_seeds(n, 7000, dev)]
    seeds = draw_seeds(n_rate, 6000, dev)
    hz_p = args.steps / pipelined_time_fn(lambda x, s: ep(x, s)[0], [(x0, s) for s in seeds],
                                          args.rate_batches)
    ep_long = panda_episode(teacher, args.sustained_steps, dev)
    long_seed = draw_seeds(1, 9000, dev)[0]
    ep_long.launches = 0
    dt = _best_of(lambda: (ep_long(x0, long_seed), _sync(dev)), args.sustained_reps)
    emit("panda_rbd_whole_episode_kernel_hz", args.sustained_steps / dt, pipelined=hz_p,
         sustained_steps=args.sustained_steps, entry=ep.name, plan=ep.plan,
         smem_bytes=ep.smem_bytes, sustained_launches=ep_long.launches,
         **cost_fields("episode", [float(c) for c in costs], True),
         note="the CFG teacher loop, the unrolled RNE plant, the FK context and the Philox "
              "draw in one launch per episode")

    # ---- the quadrotor's flagship teacher ----
    if not args.skip_quadrotor:
        qplant, quad_cost = get_plant("quadrotor")
        q_in, q_c = (st.to(dev) for st in quadrotor_stats())
        qmodel = load_quadrotor_teacher(gys.TEACHER, device=dev)
        x0_q = torch.tensor(Q_X0, dtype=torch.float32, device=dev)
        guide_builder = make_loop_guide_builder(qplant, q_in, 0.1)

        def qloop(guided: bool, n_steps: int):
            return make_closed_loop(
                GaussianDiffusion(make_schedule("exponential", tys.T)), qmodel, q_in, q_c, qplant,
                make_task_cost(quad_cost), horizon=48, n_steps=n_steps, w=tys.W,
                n_diffusion_steps_without_noise=tys.N_TAIL,
                guide_builder=guide_builder if guided else None, n_guide_steps=1,
                t_start_guide=12.5, device=dev)

        q_steps = min(Q_STEPS, args.steps)
        gen = torch.Generator(device=dev).manual_seed(20)
        q_noise = torch.randn((n_rate, q_steps, tys.T + tys.N_TAIL + 1, 1, 48, 4), generator=gen,
                              device=dev)
        for guided, tag in ((False, "unguided"), (True, "guided")):
            loop = qloop(guided, q_steps)
            dt = pipelined_time_fn(lambda x, z: loop(x, z).x_track,
                                   [(x0_q, q_noise[i]) for i in range(n_rate)], args.rate_batches)
            emit(f"quadrotor_closed_loop_hz_{tag}", q_steps / dt, n_steps=q_steps,
                 config="H=48 ch=4 ctx=12 CFG 25+5")
        if not args.skip_guided_sustained:
            long = qloop(True, args.sustained_steps)
            gen = torch.Generator(device=dev).manual_seed(21)
            noise = torch.randn((args.sustained_steps, tys.T + tys.N_TAIL + 1, 1, 48, 4),
                                generator=gen, device=dev)
            dt = _best_of(lambda: (long(x0_q, noise), _sync(dev)), args.sustained_reps)
            emit("quadrotor_sustained_hz_guided", args.sustained_steps / dt,
                 sustained_steps=args.sustained_steps)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps({"rows": rows, "card": card, "device": str(dev)}, indent=2))
    if failed:
        raise SystemExit(f"bench_highdim: the mean cost of {failed} lies outside the yardstick's "
                         "bounds")
    return {"rows": rows, "card": card}


if __name__ == "__main__":
    main()
