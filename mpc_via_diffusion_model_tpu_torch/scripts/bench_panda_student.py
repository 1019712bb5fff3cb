"""The panda arm's on-policy student on the card: the port of the JAX
package's ``scripts/bench_panda_student.py``, its protocol and JSON keys,
plus ``--device``.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.bench_panda_student \\
        [--steps 80] [--sustained-steps 400] [--candidates 16] [--sel-h 32] \\
        [--whole-episode] [--rate-batches 3] [--sustained-reps 3] [--device cuda] [--out PATH]

The DAgger 1-eval student (``--student-dir``, default
``artifacts/onpolicy_panda``; times grid [23]) with the statistics of
``data/panda_stats.py`` (the JAX script's ``--teacher`` dataset, which the
chip copy leaves out) regulates the rigid-body arm from x0 = 0.3 rad on every
joint of the shifted state, its context the 20-dim ``make_panda_context``.
Rows, each with the mean of its 10 episodes' summed stage costs
(``<tag>_cost_mean10``, the 10 episodes run as one batched loop: the chain
kernel holds each episode's samples in clusters of their own), whether that
mean lies within ``data/panda_yardstick.py``'s bounds of the JAX package's
on the CPU, its pipelined rate (8 episodes of ``--steps`` replans issued
back to back, best of ``--rate-batches`` batches, 3 as in the JAX script)
and its sustained rate (one ``--sustained-steps`` episode, best of
``--sustained-reps`` after a warm-up):

- ``k1`` and ``k{K}_selh{sel_h}`` for each ``--candidates`` K: the chain
  split, ``make_closed_loop`` with the DDIM chain kernel as
  ``sample_override`` and the plant ``panda_rbd`` stepped in torch
  (candidates rolled out over ``--sel-h`` steps);
- with ``--whole-episode``, ``episode`` (K = 1) and ``episode_k4_selh16``:
  the DDIM episode kernel's panda entry (``ddim_episode_panda``: the
  student, the context map and ``PandaRbd`` in one launch per episode),
  on staged noise; the JAX script's K = 4 row has no sustained rate, this
  one has.

Each row's noise is drawn from ``torch.Generator(device).manual_seed(7)``
(the JAX script splits ``PRNGKey(7)``), the rates' from seed 3. Every rate
line carries the card's name and power limit (``nvidia-smi``); no TPU
number is a target. The report goes to ``--out``
(``chiprun_out/bench_panda_student.json`` by default), never under
``artifacts/``. The eager arm's rollouts are launch-bound: the K = 16 row's
80-replan episodes take ~20 s each on an H100, so the full protocol takes
about 17 minutes there, and ``--rate-batches 1 --sustained-reps 1`` about 7.
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
from ..data import panda_yardstick as pys
from ..data.panda_stats import panda_stats
from ..diffusion.gaussian_diffusion import GaussianDiffusion
from ..dynamics.arm import make_panda_context, panda_cost, panda_rbd, panda_rbd_unrolled
from ..eval.timing import pipelined_time_fn
from ..models.weights import load_panda_student
from ..ops.fused_denoise import make_fused_ddim_chain
from ..ops.fused_episode import make_fused_ddim_episode
from ..utils.device import resolve_device

__all__ = ["chain_loop", "episode", "staged_noise", "main"]

ROOT = Path(__file__).resolve().parents[2]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def staged_noise(n: int, n_steps: int, k: int, dev, seed: int) -> torch.Tensor:
    """(n, n_steps, K, 128, 7): n episodes' per-replan initial draws."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, n_steps, k, pys.H, 7), generator=gen, device=dev)


def chain_loop(student, k: int, sel_h, n_steps: int, n_starts: int, dev):
    """(loop, chain): the chain split's closed loop over ``n_starts`` starts
    at once, the DDIM chain kernel at ``n_starts`` x K samples as its
    sampler, the plant ``panda_rbd``; ``loop(x0 (n_starts, 14), noise
    (n_starts, n_steps, K, 128, 7))``."""
    schedule = make_schedule("exponential", pys.T)
    chain = make_fused_ddim_chain(student, schedule, pys.TIMES, n_samples=n_starts * k,
                                  device=dev)
    ins, cond = (st.to(dev) for st in panda_stats())
    loop = make_closed_loop(GaussianDiffusion(schedule), student, ins, cond, panda_rbd(),
                            panda_cost(), horizon=pys.H, n_steps=n_steps, n_candidates=k,
                            state_to_condition=make_panda_context(), sample_override=chain,
                            selection_horizon=sel_h, noise_shape=(k, pys.H, 7), device=dev)
    return loop, chain


def episode(student, k: int, sel_h, n_steps: int, dev):
    """The DDIM episode kernel's panda entry: ``episode(x0 (14,), noise
    (n_steps, K, 128, 7))``; its plain version steps ``panda_rbd_unrolled``."""
    ins, cond = (st.to(dev) for st in panda_stats())
    return make_fused_ddim_episode(student, make_schedule("exponential", pys.T), pys.TIMES, ins,
                                   cond, panda_rbd_unrolled(), panda_cost(), n_steps=n_steps,
                                   n_candidates=k, selection_horizon=sel_h,
                                   state_to_condition=make_panda_context(), device=dev)


def _best_of(fn, n: int) -> float:
    """Seconds of the fastest of ``n`` synchronised calls, after a warm-up."""
    fn()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--student-dir", default=str(ROOT / "artifacts" / "onpolicy_panda"))
    p.add_argument("--steps", type=int, default=pys.N_STEPS)
    p.add_argument("--sustained-steps", type=int, default=400)
    p.add_argument("--candidates", type=int, nargs="*", default=[16])
    p.add_argument("--sel-h", type=int, default=32)
    p.add_argument("--whole-episode", action="store_true")
    p.add_argument("--rate-batches", type=int, default=3)
    p.add_argument("--sustained-reps", type=int, default=3)
    p.add_argument("--device", default=None, help="cuda unless given")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "bench_panda_student.json"))
    args = p.parse_args(argv)
    out_path = Path(args.out).resolve()
    if (ROOT / "artifacts") in out_path.parents:
        raise SystemExit(f"--out {args.out}: the report goes under chiprun_out/, not artifacts/")
    dev = resolve_device(args.device)
    student = load_panda_student(Path(args.student_dir) / "student_1eval.pkl", device=dev)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout.strip()
            if dev.type == "cuda" else "cpu")
    x0 = torch.from_numpy(pys.x0()).to(dev)
    n = pys.N_SEEDS
    out = {"times": pys.TIMES, "n_steps": args.steps, "sustained_steps": args.sustained_steps,
           "seeds": n, "rate_batches": args.rate_batches, "sustained_reps": args.sustained_reps,
           "device": str(dev), "card": card}

    def finish(tag: str, k: int, costs, pipelined_s: float, sustained_s: float, split: str):
        costs = [float(c) for c in costs]
        row = {f"{tag}_cost_mean10": float(np.mean(costs)), f"{tag}_costs": costs,
               f"{tag}_hz_pipelined": args.steps / pipelined_s,
               f"{tag}_hz_sustained": args.sustained_steps / sustained_s}
        if tag in pys.BOUNDS and args.steps == pys.N_STEPS:
            row[f"{tag}_within_yardstick"] = pys.within(tag, costs)
            row[f"{tag}_yardstick_gaps"] = pys.gaps(tag, costs)
        out.update(row)
        print(json.dumps({"metric": f"panda_onpolicy_{tag}_hz", "K": k, "split": split,
                          "pipelined": row[f"{tag}_hz_pipelined"],
                          "sustained": row[f"{tag}_hz_sustained"],
                          "cost_mean10": row[f"{tag}_cost_mean10"], "card": card}), flush=True)

    rate_keys = staged_noise(8, args.steps, max([1, 4] + args.candidates), dev, seed=3)

    def chain_row(k: int, sel_h, tag: str):
        loop, _ = chain_loop(student, k, sel_h, args.steps, n, dev)
        costs = loop(x0.expand(n, 14), staged_noise(n, args.steps, k, dev, 7)).stage_costs
        one, _ = chain_loop(student, k, sel_h, args.steps, 1, dev)
        argsx = [(x0, rate_keys[i, :, :k]) for i in range(8)]
        pipelined = pipelined_time_fn(lambda x, z: one(x, z).x_track, argsx, args.rate_batches)
        long, _ = chain_loop(student, k, sel_h, args.sustained_steps, 1, dev)
        long_noise = staged_noise(1, args.sustained_steps, k, dev, 9)[0]
        sustained = _best_of(lambda: (long(x0, long_noise), _sync(dev)), args.sustained_reps)
        finish(tag, k, costs.double().sum(-1).tolist(), pipelined, sustained,
               "DDIM chain kernel per replan, the arm stepped in torch")

    def episode_row(k: int, sel_h, tag: str):
        ep = episode(student, k, sel_h, args.steps, dev)
        noise = staged_noise(n, args.steps, k, dev, 7)
        costs = [ep(x0, noise[i])[2].double().sum() for i in range(n)]
        argsx = [(x0, rate_keys[i, :, :k]) for i in range(8)]
        pipelined = pipelined_time_fn(lambda x, z: ep(x, z)[0], argsx, args.rate_batches)
        long = episode(student, k, sel_h, args.sustained_steps, dev)
        long_noise = staged_noise(1, args.sustained_steps, k, dev, 9)[0]
        sustained = _best_of(lambda: (long(x0, long_noise), _sync(dev)), args.sustained_reps)
        finish(tag, k, costs, pipelined, sustained, "ddim_episode_panda, one launch per episode")

    chain_row(1, None, "k1")
    for k in args.candidates:
        chain_row(k, args.sel_h, f"k{k}_selh{args.sel_h}")
    if args.whole_episode:
        episode_row(1, None, "episode")
        episode_row(4, 16, "episode_k4_selh16")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=2))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
