"""Where a launch of the fused conv block kernel spends its time, on the card.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.conv_profile [--launches 20]

No profiler reaches inside one launch, so this script builds a copy of
``csrc/fused_conv.cu`` whose thread 0 of every CTA reads the SM's
``clock64()`` at the kernel's steps and the card's ``%globaltimer`` at its
start and end, into a table in device memory. The steps: the copies issued
(with the zero fill and the column table), the operands in place (the
cp.async wait and the block barrier), the product (the pre-bias where given,
the k8 steps of warp 0), the split-K reduction (two block barriers and the
partials' adds), and the epilogue (bias, the two passes of statistics,
normalisation, Mish, stores). The copy lives under ``build/conv_profile/``
and is made by text substitution of the committed source, so a change to it
that moves a marked line makes this script raise instead of measuring
something else; it launches through the wrapper's own ``_launch``. It also
times an empty kernel on the same grid, by ``conv_timing.graph_ms``, as the
floor of a launch.

At each of ``bench_kernels``' six shapes it makes ``--launches`` measured
launches after 10 warm-up ones, each followed by a synchronisation and a read
of the table, and prints one JSON line per shape: per CTA the median and the
largest time from start to end, the spread of the CTAs' starts, the first
start to the last end, and per step the median and the largest cycles over
CTAs and launches; then nvidia-smi's name and power limit. The marks cost a
few instructions each.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..ops import _build
from ..ops.fused_conv import FusedConv1dGnMish, conv_plan
from ..utils.device import resolve_device
from .bench_kernels import CONV_SHAPES
from .conv_timing import graph_ms

STEPS = ("issue", "ready", "product", "reduce", "epilogue")
MAX_CTAS = 4096
_MARKS = '''#define CONV_KS 5        // taps
__device__ unsigned long long g_marks[''' + str(MAX_CTAS) + '''][8];
static __device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
// slot 0 and 7: globaltimer at start and end; slots 1-6: clock64 at the steps
#define MARK(i) do { if (threadIdx.x == 0) \\
  g_marks[blockIdx.y * gridDim.x + blockIdx.x][i] = (i == 0 || i == 7) ? global_ns() : clock64(); \\
} while (0)
__global__ void conv_profile_empty_kernel() {}'''
_READ = '''int fused_conv_meta_len(void) { return M_LEN; }

int conv_profile_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks));
}

int conv_profile_empty_launch(int gx, int gy, int threads, void* stream) {
  conv_profile_empty_kernel<<<dim3(gx, gy), threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}'''


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"conv_profile: expected one {old!r} in fused_conv.cu")
    return text.replace(old, new)


def instrument(csrc: Path, out: Path) -> None:
    """Copies ``csrc`` to ``out`` with the marks in ``fused_conv.cu``."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    s = (out / "fused_conv.cu").read_text()
    s = _sub(s, "#define CONV_KS 5        // taps", _MARKS)
    s = _sub(s, "  const int kc = CONV_KS * cin, xst = p.x_stride;\n",
             "  const int kc = CONV_KS * cin, xst = p.x_stride;\n  MARK(0);\n  MARK(1);\n")
    s = _sub(s, "  cp_async_wait_all();\n  __syncthreads();\n",
             "  MARK(2);\n  cp_async_wait_all();\n  __syncthreads();\n  MARK(3);\n")
    s = _sub(s, "  // 3. the split-K reduction, the partials over the operands\n",
             "  MARK(4);\n  // 3. the split-K reduction, the partials over the operands\n")
    s = _sub(s, "  // 4. the epilogue: register i", "  MARK(5);\n  // 4. the epilogue: register i")
    s = _sub(s, "        o[0] = v0;\n      }\n    }\n  }\n}\n",
             "        o[0] = v0;\n      }\n    }\n  }\n  MARK(6);\n  MARK(7);\n}\n")
    s = _sub(s, "int fused_conv_meta_len(void) { return M_LEN; }", _READ)
    (out / "fused_conv.cu").write_text(s)


def build_copy(src: Path) -> ctypes.CDLL:
    """nvcc on the edited copy ``src/fused_conv.cu`` with the port's flags,
    into ``src/libfused_conv.so``; returns the library with its C interface
    declared as ``FusedConv1dGnMish._launch`` calls it."""
    lib_path = src / "libfused_conv.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                           str(src / "fused_conv.cu")], capture_output=True, text=True,
                          timeout=_build.NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src / 'fused_conv.cu'}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    pv, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_conv_launch.argtypes = [pv] * 7 + [i] * 5 + [f, i, pv]
    lib.fused_conv_launch.restype = i
    lib.fused_conv_error_string.argtypes, lib.fused_conv_error_string.restype = [i], ctypes.c_char_p
    lib.conv_profile_read.argtypes, lib.conv_profile_read.restype = [pv], i
    lib.conv_profile_empty_launch.argtypes, lib.conv_profile_empty_launch.restype = [i, i, i, pv], i
    return lib


def launch_copy(conv: FusedConv1dGnMish, lib: ctypes.CDLL, args: tuple, out: torch.Tensor):
    """One launch of the conv block on the built copy ``lib`` in place of
    the port's library, through the wrapper's own ``_launch``; ``args`` is
    (x, w, b, gamma, beta, groups)."""
    x, w, b, gamma, beta, groups = args
    return conv._launch(x, w, b, gamma, beta, None, out, groups, 1e-5, lib=lib)


def main(argv: Optional[list] = None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--launches", type=int, default=20)
    args = p.parse_args(argv)
    dev = resolve_device(None)  # raises without a card
    src = _build.BUILD_DIR.parent / "conv_profile"
    instrument(_build.CSRC, src)
    lib = build_copy(src)
    conv = FusedConv1dGnMish()
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for bsz, h, cin, cout in CONV_SHAPES:
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        c_args = (rnd(bsz, h, cin), rnd(5, cin, cout) * 0.1, rnd(cout), rnd(cout), rnd(cout),
                  8 if cout % 8 == 0 else 1)
        out = torch.empty((bsz, h, cout), device=dev)
        plan = conv_plan(bsz, h, cin, cout, c_args[-1])
        n_cta = plan.grid[0] * plan.grid[1]
        if n_cta > MAX_CTAS:
            raise RuntimeError(f"conv_profile: {n_cta} CTAs, the table holds {MAX_CTAS}")
        table = np.zeros((MAX_CTAS, 8), np.uint64)
        marks = []
        for i in range(10 + args.launches):
            launch_copy(conv, lib, c_args, out)
            torch.cuda.synchronize()
            err = lib.conv_profile_read(table.ctypes.data)
            if err:
                raise RuntimeError(f"reading the marks failed: {lib.fused_conv_error_string(err).decode()}")
            if i >= 10:
                marks.append(table[:n_cta].astype(np.int64))
        t = np.stack(marks)                                   # (launches, CTAs, 8)
        steps = np.diff(t[:, :, 1:7], axis=2)                 # cycles of each step
        per_cta = t[:, :, 7] - t[:, :, 0]
        empty = lambda: lib.conv_profile_empty_launch(plan.grid[0], plan.grid[1],
                                                      32 * 8, stream())
        rows.append({
            "shape": [bsz, h, cin, cout], "ctas": n_cta,
            "cta_ns_median": float(np.median(per_cta)),
            "cta_ns_max": float(np.median(per_cta.max(1))),
            "start_spread_ns": float(np.median(t[:, :, 0].max(1) - t[:, :, 0].min(1))),
            "first_start_to_last_end_ns": float(np.median(t[:, :, 7].max(1) - t[:, :, 0].min(1))),
            "clock_ghz": float(np.median((t[:, :, 6] - t[:, :, 1]) / per_cta)),
            "cycles_median": dict(zip(STEPS, np.median(steps.reshape(-1, len(STEPS)), 0).tolist())),
            "cycles_max": dict(zip(STEPS, np.median(steps.max(1), 0).tolist())),
            "empty_kernel_graph_ms": graph_ms(empty)})
        print(json.dumps(rows[-1]), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return rows


if __name__ == "__main__":
    main()
