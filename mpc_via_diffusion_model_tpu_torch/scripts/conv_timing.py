"""Times the fused conv block kernel (``ops/csrc/fused_conv.cu``) on the card at
``bench_kernels``' six shapes, the device's time apart from the host's:

- the launch alone as the device sees it: 100 launches captured into one
  CUDA graph (``torch.cuda.graph``), the graph replayed between CUDA
  events, the time divided by the launches;
- the whole call, ``fused_conv1d_gn_mish.kernel`` (the wrapper's checks,
  its allocation and the ctypes launch), by CUDA events around 200 calls;
- the kernel's own device time per launch from ``torch.profiler``'s
  ``key_averages()``, or None where the profiler records no device time.

It uses only what every version of the port's conv wrapper has: it captures
``_launch`` on a prepared output where the wrapper has one, else ``kernel``,
which launches the same kernel once. So it also times an older checkout of
the port, whose package and ``csrc/`` it imports and builds instead of this
one's. Run it as a file from the repository root::

    python3 mpc_via_diffusion_model_tpu_torch/scripts/conv_timing.py [--root DIR] [--label NAME]

It prints one JSON line: the label, the card, nvidia-smi's name and power
limit, and one row per shape. It needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, Optional

import torch

N_GRAPH, N_REPLAY = 100, 10    # launches captured in the graph; replays timed
N_CALL, N_PROFILE = 200, 20


def graph_ms(fn: Callable[[], object], n: int = N_GRAPH, replays: int = N_REPLAY) -> float:
    """Milliseconds per call of ``fn`` as the device runs it: ``n`` calls
    captured into one CUDA graph after a warm-up call, ``replays`` replays
    between CUDA events. Captured in relaxed mode, so that a launcher that
    sets a kernel attribute on every launch is captured too."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


def cuda_ms(fn: Callable[[], object], n: int = N_CALL, warmup: int = 10) -> float:
    """Milliseconds per call of ``fn`` by CUDA events around ``n`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def profiler_ms(fn: Callable[[], object], kernel: str = "fused_conv_kernel",
                n: int = N_PROFILE) -> Optional[float]:
    """The device time per launch of the kernels whose name holds ``kernel``
    over ``n`` calls of ``fn``, from ``torch.profiler``; None when the
    profiler records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    total_us, count = sum(e.device_time_total for e in events), sum(e.count for e in events)
    return total_us / count / 1e3 if count and total_us > 0 else None


def launch_alone(conv, args: tuple) -> Callable[[], object]:
    """One launch of the conv kernel on prepared tensors: ``conv._launch``
    where the wrapper has it, else ``conv.kernel``."""
    if not hasattr(conv, "_launch"):
        return lambda: conv.kernel(*args)
    x, w, b, gamma, beta, groups = args
    out = torch.empty((x.shape[0], x.shape[1], w.shape[2]), device=x.device)
    return lambda: conv._launch(x, w, b, gamma, beta, None, out, groups, 1e-5)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the checkout whose package and kernels are timed (default: this one)")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_timing: no CUDA device; it times the kernel on an NVIDIA GPU")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import mpc_via_diffusion_model_tpu_torch as pkg
    from mpc_via_diffusion_model_tpu_torch.ops import fused_conv1d_gn_mish as conv
    from mpc_via_diffusion_model_tpu_torch.scripts.bench_kernels import CONV_SHAPES
    if Path(pkg.__file__).resolve().parents[1] != root:
        raise SystemExit(f"conv_timing: imported {pkg.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for bsz, h, cin, cout in CONV_SHAPES:
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        c_args = (rnd(bsz, h, cin), rnd(5, cin, cout) * 0.1, rnd(cout), rnd(cout), rnd(cout),
                  8 if cout % 8 == 0 else 1)
        alone = launch_alone(conv, c_args)
        rows.append({"shape": [bsz, h, cin, cout], "launch_ms": graph_ms(alone),
                     "call_ms": cuda_ms(lambda: conv.kernel(*c_args)),
                     "profiler_ms": profiler_ms(alone)})
    result = {"label": args.label, "root": str(root), "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "rows": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
