"""Where a train step's time goes: the eager step's rate at batch 512 on the
LMPC model, and one ``torch.profiler`` trace of a few steps.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.train_profile [--device cpu] \\
        [--batch 512] [--steps 200] [--profiled 5]

Times ``--steps`` steps as one ``make_scanned_train_steps`` chunk (after a
chunk of warm-up) by the host clock and by CUDA events, then traces
``--profiled`` steps and prints one JSON object: steps per second, ms per
step, and per step the device kernels launched, the ATen calls made on the
host, the device's busy time (the traced kernels' durations) and its idle
share (1 - busy over the untraced ms per step), with the ten ATen operators
of most host time in the trace. The data are random rows of the
recipe's shapes (the step's cost does not depend on them).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..core import make_schedule
from ..data.datasets import ControlSequenceDataset
from ..diffusion import GaussianDiffusion
from ..train import Trainer, make_scanned_train_steps
from ..utils.device import resolve_device
from . import flagship_lmpc


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--batch", type=int, default=flagship_lmpc.BATCH)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--profiled", type=int, default=5)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.RandomState(0)
    ds = ControlSequenceDataset.from_arrays(rng.randn(20_000, flagship_lmpc.HORIZON, 1),
                                            rng.randn(20_000, 4), device=dev)
    trainer = Trainer(GaussianDiffusion(make_schedule("exponential", flagship_lmpc.T)),
                      flagship_lmpc.lmpc_model(dev), lr=flagship_lmpc.LR, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    run = lambda state, n: make_scanned_train_steps(trainer.train_step, n)(
        state, ds.inputs_normalized, ds.condition_normalized, args.batch, gen)
    state, loss = run(trainer.state, args.steps)
    float(loss)
    _sync(dev)
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)] if dev.type == "cuda"
              else None)
    t0 = time.perf_counter()
    if events:
        events[0].record()
    state, loss = run(state, args.steps)
    float(loss)
    if events:
        events[1].record()
    _sync(dev)
    wall_s = time.perf_counter() - t0
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        state, loss = run(state, args.profiled)
        float(loss)
        _sync(dev)
    ms_per_step = 1e3 * wall_s / args.steps
    evs = prof.events()
    kernels = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3 / args.profiled
    top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "batch": args.batch, "steps": args.steps, "steps_per_s": args.steps / wall_s,
           "ms_per_step": ms_per_step,
           "ms_per_step_cuda_events": events[0].elapsed_time(events[1]) / args.steps if events
           else None,
           "profiled_steps": args.profiled, "kernels_per_step": len(kernels) / args.profiled,
           "aten_calls_per_step": sum(e.name.startswith("aten::") for e in evs) / args.profiled,
           "device_busy_ms_per_step": busy_ms if kernels else None,
           "device_idle_share": 1 - busy_ms / ms_per_step if kernels else None,
           "top_host_ops_ms_per_step": {e.key: e.self_cpu_time_total / 1e3 / args.profiled
                                        for e in top}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
