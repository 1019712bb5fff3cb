"""The quadrotor flagship's guided-vs-unguided evaluation on the card: the
port of the evaluation half of the JAX package's
``scripts/flagship_quadrotor.py`` (step 3, what its ``--reuse`` re-runs) and
of the quadrotor's serving rates in ``scripts/bench_highdim.py``.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.flagship_quadrotor \\
        [--eval-starts 16] [--steps 60] [--guide-scale 0.1] [--rate-loops 2] \\
        [--no-rates] [--device cuda] [--out PATH]

The committed teacher (``artifacts/flagship_quadrotor/ema_params.pkl``,
horizon 48, 4 controls, context 12; the statistics of
``data/quadrotor_stats.py``) flies ``--steps`` replans from each of the
``--eval-starts`` starts ``eval_start_states(n)`` (seed 7), T = 25 + 5, w =
0.01, the task cost ``make_task_cost(quad_cost)`` as the loop's cost:

- ``guided``: the obstacle-clearance guide (``make_loop_guide_builder``,
  scale ``--guide-scale``) on the CFG DDPM chain's steps i < T / 2, every
  U-Net pass through the U-Net pass kernel (``FusedUnet`` at 2 N rows: the
  guide acts between steps, so no chain kernel can run it);
- ``unguided``: the same model through the CFG chain kernel
  (``FusedCfgChain`` at N rows as ``sample_override``).

Both rows run the starts as one batched loop (``make_closed_loop`` with x0
(N, 12)), each start's noise drawn in turn from ``torch.Generator(device)
.manual_seed(11)`` (the JAX script splits ``PRNGKey(11)``), and report the
``track_metrics`` with ``cost_mean`` and ``within_yardstick``: whether they
lie within ``data/guided_yardstick.py``'s bounds of the JAX package's rows
on the CPU (None where the protocol differs from the yardstick's), and each
start's min clearance; ``paired_gate`` pairs the two rows (the yardstick's
``flagship`` gate: the guide's per-start gain in clearance).

The serving rates (``bench_highdim.py:258-289``) fly one start, ``X0_Q``,
guided and unguided: ``quadrotor_closed_loop_hz_*``, ``--rate-loops``
60-replan loops issued back to back with one synchronise, after a 2-replan
warm-up (the JAX script: 8 loops, best of 3 batches); and
``quadrotor_sustained_hz_*``, one ``--steps``-replan loop timed alone (the
JAX script: 400 replans, best of 3; at ~1 replan/s the guided loop is
host-bound, so the two protocols measure the same work).

Steps 1 and 2 of the JAX script (the MPPI expert's collection and the
training) and its expert row refuse: ``solvers/mppi.py`` is not ported
(ROADMAP.md A6). The report goes to ``--out``
(``chiprun_out/flagship_quadrotor/report.json`` by default), never under
``artifacts/``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch

from ..control.runtime import make_closed_loop
from ..core.schedules import make_schedule
from ..data import guided_yardstick as gys
from ..data.normalization import NormalizerStats
from ..data.quadrotor_stats import quadrotor_stats
from ..diffusion.gaussian_diffusion import GaussianDiffusion
from ..dynamics.quadrotor import quadrotor, quadrotor_cost
from ..models.weights import load_quadrotor_teacher
from ..ops.fused_denoise import make_fused_cfg_chain
from ..ops.fused_unet import make_fused_unet
from ..ops.unet_pack import PackedUnet, pack_unet
from ..utils.device import resolve_device
from .bench_scene_student import start_noise
from .quadrotor_task import (eval_start_states, make_loop_guide_builder, make_task_cost,
                             min_clearance, track_metrics)

__all__ = ["X0_Q", "teacher", "serving_loop", "flagship_loop", "row", "rates", "main"]

ROOT = Path(__file__).resolve().parents[2]
HORIZON = 48
# scripts/bench_highdim.py's single start
X0_Q = (2.6, 0.5, 1.0) + (0.0,) * 9


def teacher(device) -> PackedUnet:
    """The quadrotor flagship's teacher, packed on ``device``."""
    dev = resolve_device(device)
    return pack_unet(load_quadrotor_teacher(gys.TEACHER, device=dev), dev)


def serving_loop(packed: PackedUnet, stats: Tuple[NormalizerStats, NormalizerStats], cost,
                 n_rows: int, n_steps: int, device, guide_builder: Optional[Callable] = None,
                 t_start_guide: float = float("inf"), n_candidates: int = 1,
                 state_to_condition: Optional[Callable] = None, route=None):
    """``(loop, route)``: ``make_closed_loop`` over ``n_rows`` states at once
    (T = 25 + 5, w = 0.01). With ``guide_builder`` the CFG DDPM sampler
    guided on its steps i < ``t_start_guide``, its denoiser ``route`` or a
    new ``FusedUnet`` at 2 n_rows K rows; without, ``route`` or a new
    ``FusedCfgChain`` at n_rows K samples as ``sample_override``. A plain
    ``route`` (``TemporalUnet``, ``FusedCfgChain.plain``) gives the loop's
    plain version."""
    dev = resolve_device(device)
    schedule = make_schedule("exponential", gys.T)
    diffusion = GaussianDiffusion(schedule).to(dev)
    rows = n_rows * n_candidates
    kw = dict(horizon=HORIZON, n_steps=n_steps, w=gys.W,
              n_diffusion_steps_without_noise=gys.N_TAIL, n_candidates=n_candidates,
              state_to_condition=state_to_condition, device=dev)
    if guide_builder is not None:
        route = route if route is not None else make_fused_unet(packed, 2 * rows, device=dev)
        loop = make_closed_loop(diffusion, route, *stats, quadrotor(), cost,
                                guide_builder=guide_builder, n_guide_steps=1,
                                t_start_guide=t_start_guide, **kw)
    else:
        route = route if route is not None else make_fused_cfg_chain(
            packed, schedule, n_samples=rows, w=gys.W, n_tail=gys.N_TAIL, device=dev)
        loop = make_closed_loop(diffusion, packed.model, *stats, quadrotor(), cost,
                                sample_override=route, **kw)
    return loop, route


def flagship_loop(packed: PackedUnet, guided: bool, n_rows: int, n_steps: int, device,
                  guide_scale: float = gys.GUIDE_SCALE, route=None):
    """``(loop, route)``: the flagship's guided or unguided row over
    ``n_rows`` starts, the task cost as the loop's cost, the guide on the
    steps i < T / 2."""
    stats = quadrotor_stats()
    gb = make_loop_guide_builder(quadrotor(), stats[0], guide_scale) if guided else None
    return serving_loop(packed, stats, make_task_cost(quadrotor_cost()), n_rows, n_steps,
                        device, guide_builder=gb, t_start_guide=gys.T_START_FLAGSHIP,
                        route=route)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def row(packed: PackedUnet, guided: bool, starts: torch.Tensor, n_steps: int, device,
        guide_scale: float = gys.GUIDE_SCALE, seed: int = gys.FLAGSHIP_KEY_SEED,
        protocol: bool = False) -> dict:
    """One row of the flagship's table over the starts (N, 12), batched:
    ``track_metrics`` with ``cost_mean``, ``within_yardstick`` (None unless
    ``protocol``) and the gaps, the seconds and the launches of its kernel."""
    dev = resolve_device(device)
    loop, route = flagship_loop(packed, guided, len(starts), n_steps, dev, guide_scale)
    noise = start_noise(len(starts), n_steps, 1, dev, seed=seed)
    route.launches = 0
    t0 = time.perf_counter()
    res = loop(starts, noise)
    _sync(dev)
    seconds = time.perf_counter() - t0
    xt = res.x_track.cpu().numpy()
    out = track_metrics(xt, res.stage_costs.cpu().numpy())
    name = "guided" if guided else "unguided"
    return dict(out, within_yardstick=gys.within(out, name) if protocol else None,
                yardstick_gaps=gys.gaps(out, name), seconds=seconds, launches=route.launches,
                kernel="fused_unet" if guided else "cfg_chain",
                clearance=min_clearance(xt).tolist())


def rates(packed: PackedUnet, guided: bool, n_steps: int, n_loops: int, device) -> dict:
    """The single-start serving rates from ``X0_Q``: ``n_loops`` loops of
    ``n_steps`` replans back to back with one synchronise (pipelined), then
    one loop alone (sustained), after a 2-replan warm-up."""
    dev = resolve_device(device)
    tag = "guided" if guided else "unguided"
    x0 = torch.tensor(X0_Q, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    loop, route = flagship_loop(packed, guided, 1, n_steps, dev)
    warm, _ = flagship_loop(packed, guided, 1, 2, dev, route=route)
    warm(x0, generator=gen)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_loops):
        x_end = loop(x0, generator=gen).x_track[-1]
    _sync(dev)
    pipelined = n_loops * n_steps / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    x_end = loop(x0, generator=gen).x_track[-1]
    _sync(dev)
    sustained = n_steps / (time.perf_counter() - t0)
    return {f"quadrotor_closed_loop_hz_{tag}": pipelined,
            f"quadrotor_sustained_hz_{tag}": sustained,
            f"{tag}_protocol": f"{n_loops} loops of {n_steps} replans pipelined; one alone",
            f"{tag}_finite": bool(torch.isfinite(x_end).all())}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--eval-starts", type=int, default=gys.N_STARTS)
    p.add_argument("--steps", type=int, default=gys.N_STEPS)
    p.add_argument("--guide-scale", type=float, default=gys.GUIDE_SCALE)
    p.add_argument("--rate-loops", type=int, default=2)
    p.add_argument("--no-rates", action="store_true", help="only the two rows")
    for flag in ("--collect", "--train", "--expert"):
        p.add_argument(flag, action="store_true", help="refused: needs solvers/mppi.py")
    p.add_argument("--device", default=None, help="cuda unless given")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "flagship_quadrotor" /
                                        "report.json"))
    args = p.parse_args(argv)
    if args.collect or args.train or args.expert:
        raise SystemExit("the MPPI expert's collection, the training and the expert row need "
                         "solvers/mppi.py, which the port does not have yet (ROADMAP.md A6)")
    out_path = Path(args.out).resolve()
    if (ROOT / "artifacts") in out_path.parents:
        raise SystemExit(f"--out {args.out}: the report goes under chiprun_out/, not artifacts/")
    dev = resolve_device(args.device)
    packed = teacher(dev)
    starts = torch.from_numpy(eval_start_states(args.eval_starts, seed=gys.FLAGSHIP_START_SEED))
    protocol = ((args.eval_starts, args.steps, args.guide_scale)
                == (gys.N_STARTS, gys.N_STEPS, gys.GUIDE_SCALE))
    out = {"teacher": str(gys.TEACHER.relative_to(ROOT)), "eval_starts": args.eval_starts,
           "steps": args.steps, "guide_scale": args.guide_scale,
           "t_start_guide": gys.T_START_FLAGSHIP, "w": gys.W, "device": str(dev),
           "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for guided in (True, False):
        name = "guided" if guided else "unguided"
        out[name] = row(packed, guided, starts.to(dev), args.steps, dev, args.guide_scale,
                        protocol=protocol)
        print(json.dumps({name: out[name]}), flush=True)
    stats = gys.paired(out["guided"]["clearance"], out["unguided"]["clearance"])
    out["paired_gate"] = dict(stats, within=gys.paired_within(stats, "flagship")
                              if protocol else None)
    print(json.dumps({"paired_gate": out["paired_gate"]}), flush=True)
    if not args.no_rates:
        out["rates"] = {}
        for guided in (False, True):
            out["rates"].update(rates(packed, guided, args.steps, args.rate_loops, dev))
        print(json.dumps({"rates": out["rates"]}), flush=True)
    if dev.type == "cuda":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=2))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
