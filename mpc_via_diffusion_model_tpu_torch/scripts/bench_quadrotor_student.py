"""The quadrotor student's serving path on the card: the port of the JAX
package's ``scripts/bench_quadrotor_student.py``, its flags, protocol and
JSON keys, plus ``--device``.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.bench_quadrotor_student \\
        [--eval-starts 64] [--candidates 4 8 16] [--in-kernel] [--inkernel-noise [K ...]] \\
        [--steps 60] [--rate-steps 600] [--fleet N [--fleet-only]] [--device cuda] [--out PATH]

The 1-eval self-distilled student (``--student-dir``, default
``artifacts/onpolicy_quadrotor``; times grid [23]) with the statistics of
``data/quadrotor_stats.py`` (the JAX script's ``--teacher`` dataset, which
the chip copy leaves out) flies ``--steps`` replans from each of the first
``--eval-starts`` of ``eval_start_states(64)`` (seed 7). Rows, each with
``track_metrics`` of its tracks:

- ``xla``: the per-replan loop, ``make_closed_loop`` with the DDIM chain
  kernel as ``sample_override`` (the JAX script's XLA row), and its
  pipelined rate (8 episodes issued back to back, best of 3 batches);
- ``episode``: the DDIM episode kernel at K = 1, its parity with the loop
  from the first start on the same noise, its pipelined rate and its
  sustained rate, one ``--rate-steps`` episode per launch, best of 3;
- ``xla_k{K}`` for each ``--candidates`` K > 1: the loop with the chain at
  B = K, candidates scored by ``make_select_cost``; with ``--in-kernel``
  also ``episode_k{K}``, the episode kernel with the safety-first scorer,
  its sustained rate one ``--rate-steps`` episode per launch on staged
  noise (the JAX script chains 60-replan episodes here: its staged table
  could not compile past the TPU's VMEM; this card has no such limit);
- ``inkernel_noise_k{K}`` for each ``--inkernel-noise`` K (no values:
  [1, 8]): the episode with the in-kernel draw (Philox, ``ops/philox.py``),
  its sustained rate one ``--rate-steps`` episode per launch;
- ``fleet{N}_steps_per_sec`` for ``--fleet N`` > 1: N independent K = 1
  episodes of ``--steps`` replans as ONE launch of the episode kernel's grid
  axis (``FusedDdimEpisode.fleet``, the JAX script's ``jax.vmap``), the starts
  the eval starts tiled to N, each episode's noise drawn in turn from
  ``torch.Generator(device).manual_seed(17)`` for the warm-up and from seed r
  for timed run r; the best of 3 runs, each one synchronised fleet launch,
  also printed as ``quadrotor_fleet{N}_control_steps_per_sec``.
  ``--fleet-only`` is a cut, not the protocol: it runs that row alone.

Each start's noise is drawn from ``torch.Generator(device).manual_seed(11)``
in turn (the JAX script splits ``PRNGKey(11)``); the in-kernel draw's seeds
from ``torch.Generator().manual_seed(11)``. Rows at K = 1 and K = 16 carry
``within_yardstick``: whether their metrics lie within
``data/quadrotor_yardstick.py``'s bounds of the JAX package's on the CPU. The
report goes to ``--out`` (``chiprun_out/bench_quadrotor_student.json`` by
default), never under ``artifacts/``; each row is also printed as a JSON
line, as the JAX script prints them. The full protocol, ``--eval-starts
64 --candidates 4 8 16 --in-kernel --inkernel-noise 1 8 16``, takes about
15 minutes on an H100, most of it the per-replan loop's best-of-K rows.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from ..control.runtime import make_closed_loop
from ..core.schedules import make_schedule
from ..data import quadrotor_yardstick as qys
from ..data.quadrotor_stats import quadrotor_stats
from ..diffusion.gaussian_diffusion import GaussianDiffusion
from ..dynamics.quadrotor import quadrotor, quadrotor_cost
from ..eval.timing import pipelined_time_fn
from ..models.weights import load_quadrotor_student
from ..ops import philox
from ..ops.fused_denoise import make_fused_ddim_chain
from ..ops.fused_episode import make_fused_ddim_episode
from ..utils.device import resolve_device
from .quadrotor_task import eval_start_states, make_select_cost, track_metrics

__all__ = ["main"]

ROOT = Path(__file__).resolve().parents[2]
HORIZON = 48


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sustained(episode, x0, arg, dev, n: int = 3) -> float:
    """Seconds of the fastest of ``n`` calls of ``episode(x0, arg)``, each
    synchronised, after one warm-up call."""
    episode(x0, arg)
    _sync(dev)
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        episode(x0, arg)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def _yardstick(row: dict, k: int) -> dict:
    """``row`` with ``within_yardstick`` (and the gaps) where the yardstick has K."""
    if k in qys.BOUNDS:
        row = dict(row, within_yardstick=qys.within(row, k), yardstick_gaps=qys.gaps(row, k))
    return row


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--student-dir", default=str(ROOT / "artifacts" / "onpolicy_quadrotor"))
    p.add_argument("--steps", type=int, default=60, help="quality-metric episode length")
    p.add_argument("--rate-steps", type=int, default=600, help="sustained-rate episode length")
    p.add_argument("--eval-starts", type=int, default=16)
    p.add_argument("--candidates", type=int, nargs="+", default=[],
                   help="K values > 1: best-of-K with safety-first selection through the "
                        "per-replan loop")
    p.add_argument("--in-kernel", action="store_true",
                   help="also run best-of-K through the episode kernel")
    p.add_argument("--inkernel-noise", type=int, nargs="*", default=None,
                   help="K values to also run with the in-kernel draw (no values: 1 8)")
    p.add_argument("--fleet", type=int, default=0,
                   help="N > 1: N independent K = 1 episodes as one launch of the episode kernel")
    p.add_argument("--fleet-only", action="store_true",
                   help="a cut, not the protocol: run the --fleet row alone")
    p.add_argument("--device", default=None, help="cuda unless given")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "bench_quadrotor_student.json"))
    args = p.parse_args(argv)
    if args.fleet_only and args.fleet <= 1:
        raise SystemExit("--fleet-only needs --fleet N > 1")
    out_path = Path(args.out).resolve()
    if (ROOT / "artifacts") in out_path.parents:
        raise SystemExit(f"--out {args.out}: the report goes under chiprun_out/, not artifacts/")
    dev = resolve_device(args.device)
    student = load_quadrotor_student(Path(args.student_dir) / "student_1eval.pkl", device=dev)
    times = qys.TIMES
    schedule = make_schedule("exponential", qys.T)
    plant, qcost = quadrotor(), quadrotor_cost()
    sel = make_select_cost(qcost)
    ins, cond = (st.to(dev) for st in quadrotor_stats())
    n = args.eval_starts
    starts = torch.from_numpy(eval_start_states(64)[:n]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    # each start's staged noise, (n, steps, K, H, 4) for the largest K run
    k_max = max([1] + [k for k in args.candidates if k > 1])
    noise = torch.randn((n, args.steps, k_max, HORIZON, 4), generator=gen, device=dev)
    seed_gen = torch.Generator().manual_seed(11)
    seeds = [philox.seed_from_generator(seed_gen).to(dev) for _ in range(n)]
    key_gen = torch.Generator(device=dev).manual_seed(3)
    keys = [torch.randn((args.steps, k_max, HORIZON, 4), generator=key_gen, device=dev)
            for _ in range(8)]
    out = {"times": times, "n_steps": args.steps, "eval_starts": n, "device": str(dev),
           "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}

    def emit(metric: str, value, **extra):
        print(json.dumps({"metric": metric, "value": value, **extra}), flush=True)

    def loop_row(k: int, tag: str, hz_key: str):
        chain = make_fused_ddim_chain(student, schedule, times, n_samples=k, device=dev)
        loop = make_closed_loop(GaussianDiffusion(schedule), student, ins, cond, plant,
                                qcost if k == 1 else sel, horizon=HORIZON, n_steps=args.steps,
                                n_candidates=k, sample_override=chain,
                                noise_shape=chain.noise_shape, device=dev)
        tracks = [loop(starts[i], noise[i, :, :k]).x_track for i in range(n)]
        out[tag] = track_metrics(torch.stack(tracks).cpu().numpy())
        argsx = [(starts[i % n], keys[i][:, :k]) for i in range(8)]
        out[hz_key] = args.steps / pipelined_time_fn(lambda x, z: loop(x, z).x_track, argsx)
        out[tag] = _yardstick(out[tag], k)
        emit(f"quadrotor_student_{tag}_hz", out[hz_key], unit="Hz", **out[tag])
        return tracks

    def episode(k: int, n_steps: int, draw: bool = False):
        return make_fused_ddim_episode(student, schedule, times, ins, cond, plant, qcost,
                                       n_steps=n_steps, n_candidates=k,
                                       selection_cost=sel if k > 1 else None,
                                       inkernel_noise=draw, device=dev)

    def fleet_row(ep):
        """N K = 1 episodes from the eval starts tiled to N, one launch per run."""
        nf = args.fleet
        x0f = starts.repeat(-(-nf // n), 1)[:nf]
        draw = lambda seed: torch.stack([torch.randn(ep.noise_shape, generator=g_, device=dev)
                                         for g_ in [torch.Generator(device=dev).manual_seed(seed)]
                                         for _ in range(nf)])
        launches = ep.launches
        ep.fleet(x0f, draw(17))
        _sync(dev)
        reps = []
        for r in range(3):
            nz = draw(r)
            t0 = time.perf_counter()
            ep.fleet(x0f, nz)
            _sync(dev)
            reps.append(time.perf_counter() - t0)
        out[f"fleet{nf}_steps_per_sec"] = nf * args.steps / min(reps)
        out[f"fleet{nf}_launches"] = ep.launches - launches
        emit(f"quadrotor_fleet{nf}_control_steps_per_sec", out[f"fleet{nf}_steps_per_sec"],
             unit="steps/s")

    if args.fleet_only:
        fleet_row(episode(1, args.steps))
        return _finish(out, out_path, dev)

    # the per-replan loop through the chain kernel (the JAX script's XLA row)
    xla_tracks = loop_row(1, "xla", "xla_hz_pipelined")
    # the episode kernel at K = 1: parity with the loop, metrics, pipelined and sustained rates
    ep = episode(1, args.steps)
    x_tr = ep(starts[0], noise[0, :, :1])[0]
    out["episode_vs_xla_max_err"] = float((x_tr - xla_tracks[0]).abs().max())
    out["episode"] = _yardstick(track_metrics(torch.stack(
        [ep(starts[i], noise[i, :, :1])[0] for i in range(n)]).cpu().numpy()), 1)
    argse = [(starts[i % n], keys[i][:, :1]) for i in range(8)]
    out["episode_hz_pipelined"] = args.steps / pipelined_time_fn(lambda x, z: ep(x, z)[0], argse)
    ep_rate = episode(1, args.rate_steps)
    rate_noise = torch.randn(ep_rate.noise_shape, generator=gen, device=dev)
    out["rate_steps"] = args.rate_steps
    out["episode_hz_sustained"] = args.rate_steps / _sustained(ep_rate, starts[0], rate_noise, dev)
    if args.fleet > 1:
        fleet_row(ep)
    emit("quadrotor_student_fused_episode_hz", out["episode_hz_pipelined"], unit="Hz",
         sustained=out["episode_hz_sustained"], max_err_vs_xla=out["episode_vs_xla_max_err"],
         **out["episode"])

    # best-of-K with safety-first selection
    k_values = [k for k in args.candidates if k > 1]
    for k in k_values:
        loop_row(k, f"xla_k{k}", f"xla_k{k}_hz_pipelined")
    for k in (k_values if args.in_kernel else []):
        ep_k = episode(k, args.steps)
        out[f"episode_k{k}"] = _yardstick(track_metrics(torch.stack(
            [ep_k(starts[i], noise[i, :, :k])[0] for i in range(n)]).cpu().numpy()), k)
        argsk = [(starts[i % n], keys[i][:, :k]) for i in range(8)]
        out[f"episode_k{k}_hz_pipelined"] = args.steps / pipelined_time_fn(
            lambda x, z: ep_k(x, z)[0], argsk)
        ep_long = episode(k, args.rate_steps)
        long_noise = torch.randn(ep_long.noise_shape, generator=gen, device=dev)
        out[f"episode_k{k}_hz_sustained"] = args.rate_steps / _sustained(
            ep_long, starts[0], long_noise, dev)
        out[f"episode_k{k}_sustained_protocol"] = f"single-dispatch {args.rate_steps}-step, staged"
        emit(f"quadrotor_student_fused_episode_k{k}_hz", out[f"episode_k{k}_hz_pipelined"],
             unit="Hz", sustained=out[f"episode_k{k}_hz_sustained"], **out[f"episode_k{k}"])

    # the in-kernel draw: single-dispatch long episodes
    ik_values = args.inkernel_noise
    if ik_values is not None and len(ik_values) == 0:
        ik_values = [1, 8]
    for k in (ik_values or []):
        tag = f"inkernel_noise_k{k}"
        ep_q = episode(k, args.steps, draw=True)
        out[tag] = _yardstick(track_metrics(torch.stack(
            [ep_q(starts[i], seeds[i])[0] for i in range(n)]).cpu().numpy()), k)
        ep_long = episode(k, args.rate_steps, draw=True)
        out[f"{tag}_hz_sustained_single_dispatch"] = args.rate_steps / _sustained(
            ep_long, starts[0], seeds[0], dev)
        emit(f"quadrotor_student_{tag}_hz", out[f"{tag}_hz_sustained_single_dispatch"],
             unit="Hz", protocol=f"single-dispatch {args.rate_steps}-step", **out[tag])

    return _finish(out, out_path, dev)


def _finish(out: dict, out_path: Path, dev) -> dict:
    """The report with the card's name and power limit, written to ``out_path`` and printed."""
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
