"""Where a guided replan's time goes on the card: one replan of the quadrotor
flagship's guided loop from ``bench_highdim.py``'s start (one state, the
guide on 18 of the 30 steps) and one of the scene study's per-scene guided
oracle over scene 0's 16 starts (one batched loop, the guide on 12 steps),
each timed by the host clock after a warm-up replan and then traced by
``torch.profiler``:

    python3 -m mpc_via_diffusion_model_tpu_torch.scripts.guided_profile [--out PATH]

For each it prints the wall milliseconds per replan (untraced), the traced
replan's CUDA kernels and ATen calls, the device's busy milliseconds (the
kernels' summed durations) and idle share, the U-Net pass kernel's share of
the busy time, the heaviest kernels by device time and the heaviest host
ops by self CPU time. Tracing a replan's ~170,000 kernels takes the
profiler about a minute on the card. The report goes to ``--out``
(``chiprun_out/guided_profile.json`` by default).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..data import guided_yardstick as gys
from ..utils.device import resolve_device
from .bench_scene_student import start_noise
from .flagship_quadrotor import X0_Q, flagship_loop, teacher
from .guided_divergence import scene0, starts
from .scene_conditioned_quadrotor import teacher_loop

__all__ = ["trace_replan", "main"]

ROOT = Path(__file__).resolve().parents[2]


def trace_replan(loop, x0: torch.Tensor, noise: torch.Tensor) -> dict:
    """One replan of the 1-replan ``loop`` timed (after a warm-up) and traced."""
    loop(x0, noise)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop(x0, noise)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop(x0, noise)
        torch.cuda.synchronize()
    evs = prof.events()
    kernels = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top_k = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:6]
    top_host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    return {"wall_ms": wall_ms, "kernels": len(kernels),
            "aten_calls": sum(e.name.startswith("aten::") for e in evs),
            "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "fused_unet_busy_ms": sum(v for k, v in by_name.items() if "fused_unet" in k),
            "top_kernels_ms": dict(top_k),
            "top_host_ops_ms": {e.key: e.self_cpu_time_total / 1e3 for e in top_host}}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "guided_profile.json"))
    args = p.parse_args(argv)
    dev = resolve_device(None)
    packed = teacher(dev)
    gen = torch.Generator(device=dev).manual_seed(41)
    loop, _ = flagship_loop(packed, True, 1, 1, dev)
    x0 = torch.tensor(X0_Q, device=dev)
    noise = torch.randn((1, gys.T + gys.N_TAIL + 1, 1, 48, 4), generator=gen, device=dev)
    out = {"flagship_guided_one_start": trace_replan(loop, x0, noise)}
    print(json.dumps(out), flush=True)
    c, r = scene0()
    x0s = torch.from_numpy(starts("oracle")).to(dev)
    n = len(x0s)
    cen = torch.from_numpy(np.repeat(c[None], n, axis=0)).to(dev)
    rad = torch.from_numpy(np.repeat(r[None], n, axis=0)).to(dev)
    loop, _ = teacher_loop(packed, cen, rad, 1, dev, guided=True)
    out["scene_oracle_16_starts"] = trace_replan(loop, x0s, start_noise(n, 1, 1, dev, seed=41))
    out["device_name"] = torch.cuda.get_device_name(dev)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=2))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
