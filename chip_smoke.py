#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one card,
nvcc (``/usr/local/cuda``) and the flagship weights in
``artifacts/flagship/ema_params.pkl``, and writes nothing but the kernel
build under ``build/torch_kernels/``. Phases, each printing one line with
its own seconds:

1. device: the card's name, the device count, and nvidia-smi's name and
   power limit. Without a card the script exits non-zero and prints no result.
2. build: nvcc on ``ops/csrc/cfg_chain.cu`` for sm_90a, with its wall time
   and the ``-Xptxas -v`` register and shared-memory report.
3. kernel vs plain: the CFG chain kernel against its plain PyTorch version
   on the flagship weights at full width, three contexts, the same noise.
4. main path: the flagship cart-pole CFG closed loop, 80 replans from
   x0 = [0, 0, 3.0, 0, theta*(3.0)], with the kernel as the sampler; every
   launch count is set to 0 just before and read just after. The same loop
   through the plain version on the same noise must give the same tracks.
5. timing: the kernel and the plain version with CUDA events at the main
   path's shapes, and the closed loop's replans per second.

It then prints the ``kernels`` JSON line, the nvidia-smi line and, last, the
result line. Any failure raises, and the exit code is then not 0.

The normalizer statistics are the synthetic limits of ``bench.py`` (controls
+-30, conditions +-10): the flagship dataset's own are not in the repository.
"""
from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import torch

from mpc_via_diffusion_model_tpu_torch.control import make_closed_loop
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import NormalizerStats, normalize
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_cost,
                                                        cartpole_virtual_swingup,
                                                        theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.models import load_flagship
from mpc_via_diffusion_model_tpu_torch.ops import _build
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import make_fused_cfg_chain

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "artifacts" / "flagship" / "ema_params.pkl"
N_STEPS, HORIZON, T, N_TAIL, W = 80, 32, 25, 5, 0.01
# Kernel vs plain version, u_norm after one chain: fp32 sums in other orders
# (FMA loops vs cuDNN), ~1e-6 expected; 1e-4 is the JAX suite's chain
# tolerance. The first step's 1e6 coefficients are clipped right after and
# amplify only elements with |x - eps| < ~1e-6.
CHAIN_TOL = 1e-4
# Tracks of the 80-replan loop, kernel vs plain: per-replan differences of
# ~1e-6 in u_norm (x30 after unnormalizing) pass through 80 plant steps.
TRACK_TOL = 1e-3
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def log(phase: str, t0: float, msg: str) -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.3f}s {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def cuda_ms(fn, n: int, warmup: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, by CUDA
    events around ``n`` calls after ``warmup`` calls."""
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


def main() -> None:
    # 1. device
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script drives the port on an NVIDIA GPU")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log("device", t0, f"{kind} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    built = _build.build("cfg_chain")
    log("build", t0, f"nvcc {built.seconds:.3f}s -> {built.path.name}\n{built.report}")

    # 3. kernel vs plain version, flagship weights, full width
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    model = load_flagship(FLAGSHIP, device=dev)
    schedule = make_schedule("exponential", T)
    chain = make_fused_cfg_chain(model, schedule, n_samples=1, w=W, n_tail=N_TAIL, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_total = T + N_TAIL
    noise = torch.randn((n_total + 1, 1, HORIZON, 1), generator=gen, device=dev)
    x0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    inputs_stats = NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0))
    cond_stats = NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0))
    contexts = [normalize(cond_stats.to(dev), x0)[None]] + [
        torch.randn((1, 5), generator=gen, device=dev) for _ in range(2)]
    max_err = 0.0
    for ctx in contexts:
        got, want = chain.kernel(ctx, noise), chain.plain(ctx, noise)
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise RuntimeError("cfg_chain: non-finite output")
        max_err = max(max_err, (got - want).abs().max().item())
    log("kernel-vs-plain", t0, f"cfg_chain max_abs_err={max_err:.3e} tol={CHAIN_TOL:.0e} "
        f"over {len(contexts)} contexts")
    if max_err > CHAIN_TOL:
        raise RuntimeError(f"cfg_chain disagrees with its plain version: {max_err} > {CHAIN_TOL}")

    # 4. the main path: the 80-replan CFG closed loop through the kernel
    t0 = time.perf_counter()
    diffusion = GaussianDiffusion(schedule)
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_cost()
    loop = lambda sampler: make_closed_loop(
        diffusion, model, inputs_stats, cond_stats, plant, cost, horizon=HORIZON,
        n_steps=N_STEPS, w=W, n_diffusion_steps_without_noise=N_TAIL,
        sample_override=sampler, device=dev)
    loop_kernel, loop_plain = loop(chain), loop(chain.plain)
    ep_noise = torch.randn((N_STEPS, n_total + 1, 1, HORIZON, 1), generator=gen, device=dev)
    chain.launches = chain.plain_calls = 0
    res = loop_kernel(x0, ep_noise)
    torch.cuda.synchronize()
    launches, plain_calls = chain.launches, chain.plain_calls
    if (launches, plain_calls) != (N_STEPS, 0):
        raise RuntimeError(f"main path: cfg_chain launched {launches} times and the plain chain "
                           f"ran {plain_calls} times; expected {N_STEPS} and 0")
    ref = loop_plain(x0, ep_noise)
    torch.cuda.synchronize()
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        got, want = getattr(res, name), getattr(ref, name)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"main path: non-finite {name}")
        torch.testing.assert_close(got, want, atol=TRACK_TOL, rtol=TRACK_TOL, msg=name)
    track_err = (res.x_track - ref.x_track).abs().max().item()
    cost_k, cost_p = res.stage_costs.sum().item(), ref.stage_costs.sum().item()
    log("main-path", t0, f"{N_STEPS} replans: cfg_chain launches={launches} plain chain "
        f"calls={plain_calls}; total cost kernel={cost_k:.6f} plain={cost_p:.6f}; "
        f"max |x_track diff|={track_err:.3e} tol={TRACK_TOL:.0e}; "
        f"x_final={[round(v, 6) for v in res.x_track[-1].tolist()]}")

    # 5. timing at the main path's shapes
    t0 = time.perf_counter()
    ctx = contexts[0]
    kernel_ms = cuda_ms(lambda: chain.kernel(ctx, noise), n=20, warmup=3)
    plain_ms = cuda_ms(lambda: chain.plain(ctx, noise), n=5, warmup=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loop_kernel(x0, ep_noise)
    torch.cuda.synchronize()
    control_hz = N_STEPS / (time.perf_counter() - t1)
    packed = chain.packed
    flops = packed.flops_per_pass * 2 * chain.n_samples * n_total
    n_bytes = 4 * (packed.weights.numel() + packed.meta.numel() + chain.films(ctx).numel()
                   + noise.numel() + chain.coefs.numel() + HORIZON)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S
    log("timing", t0, f"cfg_chain {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms per replan; "
        f"closed loop {control_hz:.2f} replans/s through the kernel; "
        f"{flops} FLOP, {n_bytes} B per replan")
    row = {
        "name": "cfg_chain",
        "route": "cuda",
        "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/cfg_chain.cu",
        "replaces": "mpc_via_diffusion_model_tpu/ops/fused_denoise.py:47",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "launches_per_episode": launches,
        "max_abs_diff": max_err,
        "kernel_ms": kernel_ms,
        "closed_loop_control_hz": control_hz,
    }
    print(json.dumps({"kernels": [row]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
