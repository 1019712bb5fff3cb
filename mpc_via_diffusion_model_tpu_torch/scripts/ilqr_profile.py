"""Where an iLQR iteration's time goes: the eager iteration's time at the
flagship's shapes (H = 32, 6 step sizes), and one ``torch.profiler`` trace
of a few iterations.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.ilqr_profile [--device cpu] \\
        [--batches 1 4400] [--iterations 25] [--profiled 3]

For each batch: that many solves of the flagship collection's first step
(``data/flagship_expert_yardstick.py``'s 400 nominal problems, repeated),
``--iterations`` iterations timed by the host clock and by CUDA events after
one of warm-up, then ``--profiled`` iterations traced. Prints one JSON
object: per batch the ms per iteration, and per iteration the device
kernels launched, the top-level ATen calls made on the host (those not
inside another ATen call), all ATen calls, the device's busy time (the
traced kernels' durations) and its idle share (1 - busy over the untraced
ms per iteration), with the ten ATen operators of most host time.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile

from ..data import flagship_expert_yardstick as ys
from ..dynamics import cartpole_virtual_cost, cartpole_virtual_swingup
from ..solvers import ILQRConfig, ilqr
from ..utils.device import resolve_device


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def profile_batch(dev, batch: int, n_iterations: int, n_profiled: int) -> dict:
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_cost().to(dev)
    cfg = ILQRConfig(ys.HORIZON, n_iterations)
    x0, u0 = ys.first_step_batch()
    reps = -(-batch // len(x0))
    x0, u0 = (v.repeat(reps, *[1] * (v.dim() - 1))[:batch].to(dev) for v in (x0, u0))
    alphas = torch.tensor(cfg.line_search_alphas, device=dev)[:, None]
    j, xs = ilqr._total_cost(plant, cost, x0, u0)
    carry = (u0, xs, j, torch.full(j.shape, cfg.reg_init, device=dev))

    def run(n, carry):
        for _ in range(n):
            carry = ilqr._iteration(plant, cost, x0, alphas, cfg, *carry)[:4]
        return carry

    carry = run(1, carry)
    _sync(dev)
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)] if dev.type == "cuda"
              else None)
    t0 = time.perf_counter()
    if events:
        events[0].record()
    carry = run(n_iterations, carry)
    if events:
        events[1].record()
    _sync(dev)
    ms = 1e3 * (time.perf_counter() - t0) / n_iterations
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        run(n_profiled, carry)
        _sync(dev)
    evs = prof.events()
    aten = [e for e in evs if e.name.startswith("aten::")]
    top_level = [e for e in aten if e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")]
    kernels = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3 / n_profiled
    top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    return {"batch": batch, "ms_per_iteration": ms,
            "ms_per_iteration_cuda_events": events[0].elapsed_time(events[1]) / n_iterations
            if events else None,
            "kernels_per_iteration": len(kernels) / n_profiled,
            "top_level_aten_calls_per_iteration": len(top_level) / n_profiled,
            "aten_calls_per_iteration": len(aten) / n_profiled,
            "device_busy_ms_per_iteration": busy_ms if kernels else None,
            "device_idle_share": 1 - busy_ms / ms if kernels else None,
            "top_host_ops_ms_per_iteration": {e.key: e.self_cpu_time_total / 1e3 / n_profiled
                                              for e in top}}


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--batches", type=int, nargs="+", default=[1, 4400])
    p.add_argument("--iterations", type=int, default=ys.ITERATIONS)
    p.add_argument("--profiled", type=int, default=3)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "horizon": ys.HORIZON,
           "batches": [profile_batch(dev, b, args.iterations, args.profiled)
                       for b in args.batches]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
