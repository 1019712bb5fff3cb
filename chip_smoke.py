#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one card,
nvcc (``/usr/local/cuda``) and the flagship weights in
``artifacts/flagship/ema_params.pkl``, and writes nothing but the kernel
builds under ``build/torch_kernels/``. Phases, each printing one line with
its own seconds:

1. device: the card's name, the device count, and nvidia-smi's name and
   power limit. Without a card the script exits non-zero and prints no result.
2. build: nvcc on every ``ops/csrc/*.cu`` for sm_90a, one process per
   source, all started together, with each one's wall time and its
   ``-Xptxas -v`` register, shared-memory and spill report.
3. kernel vs plain: the CFG chain kernel on three contexts, and the U-Net
   pass kernel on three (x, t, context, mask) draws at batch 2, each against
   its plain PyTorch version on the flagship weights at full width.
4. per-replan path (``BENCH_FUSED=chain``): the flagship cart-pole CFG
   closed loop, 80 replans from x0 = [0, 0, 3.0, 0, theta*(3.0)], with the
   chain kernel as the sampler; the counts are set to 0 just before and read
   just after. The first 20 replans through the plain chain on the same
   noise must give the same tracks.
5. episode, K = 1: the whole 80-replan loop as one launch of the episode
   kernel, on phase 4's noise, against the plain episode and against
   phase 4's tracks.
6. episode, K = 4, selection_horizon 8: 8 replans against the plain
   episode, the chosen candidate of every replan included.
7. bench.py's default path, the protocol ``sustained_800step_dependent_chain``:
   10 dependent 80-replan episodes through the episode kernel, each x0 the
   last episode's final state, one sync at the end; the counts are set to 0
   just before and read just after (10 episode launches, nothing else). It
   prints ``closed_loop_control_hz`` on a line of its own.
8. ``BENCH_FUSED=1``: the plain sampler's closed loop with the U-Net pass
   kernel as the denoiser, 10 replans (300 launches), against the same loop
   with the plain forward.
9. timing: every kernel and its plain version by CUDA events at the main
   path's shapes.

It then prints the ``kernels`` JSON line, the nvidia-smi line and, last, the
result line. Any failure raises, and the exit code is then not 0.

The normalizer statistics are the synthetic limits of ``bench.py`` (controls
+-30, conditions +-10): the flagship dataset's own are not in the repository.
"""
from __future__ import annotations

import json
import math
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
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import make_fused_cfg_episode
from mpc_via_diffusion_model_tpu_torch.ops.fused_unet import make_fused_unet

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "artifacts" / "flagship" / "ema_params.pkl"
N_STEPS, HORIZON, T, N_TAIL, W = 80, 32, 25, 5, 0.01
N_PLAIN_LOOP = 20          # replans of the plain per-replan loop (phase 4)
K4, SEL_H, N_STEPS_K4 = 4, 8, 8
N_CHAIN = 10               # dependent episodes of the sustained protocol
N_UNET_LOOP = 10           # replans of the BENCH_FUSED=1 loop
# Kernel vs plain version, u_norm after one chain: fp32 sums in other orders
# (FMA loops vs cuDNN), ~1e-6 expected; 1e-4 is the JAX suite's chain
# tolerance. The first step's 1e6 coefficients are clipped right after and
# amplify only elements with |x - eps| < ~1e-6. One U-Net pass: the same.
CHAIN_TOL = UNET_TOL = 1e-4
# Tracks of closed loops, kernel vs plain: per-replan differences of ~1e-6
# in u_norm (x30 after unnormalizing) pass through up to 80 plant steps.
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


def bound(flops: float, n_bytes: float) -> dict:
    """The least time the card could take: the larger of the operations over
    the fp32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def assert_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Raises unless both are finite and agree within tol; returns max |diff|."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{name}: non-finite values")
    torch.testing.assert_close(got, want, atol=tol, rtol=tol, msg=name)
    return (got.double() - want.double()).abs().max().item()


def counts(*wrappers) -> list:
    return [(w.launches, w.plain_calls) for w in wrappers]


def reset(*wrappers) -> None:
    for w in wrappers:
        w.launches = w.plain_calls = 0


def main() -> None:
    # 1. device
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script drives the port on an NVIDIA GPU")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log("device", t0, f"{kind} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi, flush=True)

    # 2. build, every kernel at once
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, b in built.items():
        print(f"  {name}: nvcc {b.seconds:.3f}s -> {b.path.name}\n{b.report}", flush=True)
    log("build", t0, f"{len(built)} libraries")

    # 3. kernels vs plain versions, flagship weights, full width
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    model = load_flagship(FLAGSHIP, device=dev)
    schedule = make_schedule("exponential", T)
    chain = make_fused_cfg_chain(model, schedule, n_samples=1, w=W, n_tail=N_TAIL, device=dev)
    unet = make_fused_unet(chain.packed, batch_size=2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_total = T + N_TAIL
    noise = torch.randn((n_total + 1, 1, HORIZON, 1), generator=gen, device=dev)
    x0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    inputs_stats = NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0))
    cond_stats = NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0))
    contexts = [normalize(cond_stats.to(dev), x0)[None]] + [
        torch.randn((1, 5), generator=gen, device=dev) for _ in range(2)]
    chain_err = 0.0
    for ctx in contexts:
        got, want = chain.kernel(ctx, noise), chain.plain(ctx, noise)
        torch.cuda.synchronize()
        chain_err = max(chain_err, assert_close("cfg_chain", got, want, CHAIN_TOL))
    mask2 = torch.tensor([[0.0], [1.0]], device=dev)  # the CFG doubling: kept, dropped
    unet_inputs = []
    for i in range(3):
        ctx = torch.randn((1, 5), generator=gen, device=dev).expand(2, 5).contiguous()
        t = torch.full((2,), [24, 7, 0][i], dtype=torch.long, device=dev)
        unet_inputs.append((torch.randn((2, HORIZON, 1), generator=gen, device=dev), t, ctx, mask2))
    unet_err = 0.0
    for args in unet_inputs:
        got, want = unet.kernel(*args), unet.plain(*args)
        torch.cuda.synchronize()
        unet_err = max(unet_err, assert_close("fused_unet", got, want, UNET_TOL))
    log("kernel-vs-plain", t0, f"cfg_chain max_abs_err={chain_err:.3e} over {len(contexts)} "
        f"contexts; fused_unet max_abs_err={unet_err:.3e} over {len(unet_inputs)} draws at "
        f"batch 2; tol {CHAIN_TOL:.0e}")

    # 4. the per-replan path: the 80-replan CFG closed loop through the chain kernel
    t0 = time.perf_counter()
    diffusion = GaussianDiffusion(schedule)
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_cost()
    loop = lambda n_steps, **kw: make_closed_loop(
        diffusion, model, inputs_stats, cond_stats, plant, cost, horizon=HORIZON,
        n_steps=n_steps, w=W, n_diffusion_steps_without_noise=N_TAIL, device=dev, **kw)
    loop_kernel = loop(N_STEPS, sample_override=chain)
    ep_noise = torch.randn((N_STEPS, n_total + 1, 1, HORIZON, 1), generator=gen, device=dev)
    reset(chain, unet)
    res = loop_kernel(x0, ep_noise)
    torch.cuda.synchronize()
    chain_launches = chain.launches
    if counts(chain, unet) != [(N_STEPS, 0), (0, 0)]:
        raise RuntimeError(f"per-replan path: counts {counts(chain, unet)}; expected "
                           f"{N_STEPS} chain launches and nothing else")
    ref = loop(N_PLAIN_LOOP, sample_override=chain.plain)(x0, ep_noise[:N_PLAIN_LOOP])
    torch.cuda.synchronize()
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        got = getattr(res, name)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"per-replan path: non-finite {name}")
        assert_close(name, got[:len(getattr(ref, name))], getattr(ref, name), TRACK_TOL)
    log("per-replan-path", t0, f"{N_STEPS} replans: cfg_chain launches={chain_launches}; "
        f"total cost {res.stage_costs.sum().item():.6f}; first {N_PLAIN_LOOP} replans equal the "
        f"plain chain's to atol = rtol = {TRACK_TOL:.0e}; x_final={[round(v, 6) for v in res.x_track[-1].tolist()]}")

    # 5. the episode kernel at K = 1 on phase 4's noise
    t0 = time.perf_counter()
    episode = lambda k, n_steps, sel_h=None: make_fused_cfg_episode(
        chain.packed, schedule, inputs_stats, cond_stats, plant, cost, n_steps=n_steps, w=W,
        n_diffusion_steps_without_noise=N_TAIL, n_candidates=k, selection_horizon=sel_h,
        device=dev)
    ep1 = episode(1, N_STEPS)
    got = ep1.kernel(x0, ep_noise)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = ep1.plain(x0, ep_noise)
    torch.cuda.synchronize()
    plain_episode_s = time.perf_counter() - t1
    ep_err = 0.0
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        ep_err = max(ep_err, assert_close(f"episode K=1 {name}", g, w_, TRACK_TOL))
    if not torch.equal(got[3], want[3]):
        raise RuntimeError("episode K=1: chosen candidates differ")
    vs_loop = max(assert_close(f"episode vs per-replan loop {name}", g, getattr(res, name), TRACK_TOL)
                  for name, g in zip(("x_track", "u_track", "stage_costs"), got))
    log("episode-k1", t0, f"{N_STEPS} replans in one launch: max |kernel - plain|={ep_err:.3e}, "
        f"max |episode - per-replan loop|={vs_loop:.3e}, atol = rtol = {TRACK_TOL:.0e}; total cost "
        f"kernel={got[2].sum().item():.6f} plain={want[2].sum().item():.6f}; plain episode "
        f"{plain_episode_s:.3f}s by the host clock")

    # 6. the episode kernel at K = 4 with a truncated selection horizon
    t0 = time.perf_counter()
    ep4 = episode(K4, N_STEPS_K4, SEL_H)
    noise4 = torch.randn(ep4.noise_shape, generator=gen, device=dev)
    got4 = ep4.kernel(x0, noise4)
    torch.cuda.synchronize()
    want4 = ep4.plain(x0, noise4)
    torch.cuda.synchronize()
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got4, want4):
        ep_err = max(ep_err, assert_close(f"episode K=4 {name}", g, w_, TRACK_TOL))
    if not torch.equal(got4[3], want4[3]):
        raise RuntimeError(f"episode K=4: chosen {got4[3].tolist()} vs plain {want4[3].tolist()}")
    log("episode-k4", t0, f"{N_STEPS_K4} replans, K={K4}, selection_horizon={SEL_H}: chosen "
        f"{got4[3].tolist()} in both; max |kernel - plain| so far {ep_err:.3e}")

    # 7. bench.py's default path and protocol through the episode kernel
    t0 = time.perf_counter()
    reset(chain, unet, ep1)
    x_cur = x0
    t1 = time.perf_counter()
    for _ in range(N_CHAIN):
        ep_nz = torch.randn(ep1.noise_shape, generator=gen, device=dev)
        x_tr, _, _ = ep1(x_cur, ep_nz)
        x_cur = x_tr[-1]
    torch.cuda.synchronize()
    sustained_s = time.perf_counter() - t1
    episode_launches = ep1.launches
    if counts(ep1, chain, unet) != [(N_CHAIN, 0), (0, 0), (0, 0)]:
        raise RuntimeError(f"protocol: counts (episode, chain, unet) {counts(ep1, chain, unet)}; "
                           f"expected {N_CHAIN} episode launches and nothing else")
    if not torch.isfinite(x_cur).all():
        raise RuntimeError("protocol: non-finite final state")
    control_hz = N_CHAIN * N_STEPS / sustained_s
    print(json.dumps({"metric": "closed_loop_control_hz", "value": control_hz, "unit": "Hz",
                      "protocol": "sustained_800step_dependent_chain",
                      "episode_launches": episode_launches, "seconds": sustained_s}), flush=True)
    log("protocol", t0, f"{N_CHAIN} dependent episodes of {N_STEPS} replans: {sustained_s:.3f}s, "
        f"{control_hz:.2f} replans/s; episode launches={episode_launches}; "
        f"x_final={[round(v, 6) for v in x_cur.tolist()]}")

    # 8. BENCH_FUSED=1: the plain sampler with the U-Net pass kernel as denoiser
    t0 = time.perf_counter()
    reset(chain, unet, ep1)
    loop_unet = make_closed_loop(diffusion, unet, inputs_stats, cond_stats, plant, cost,
                                 horizon=HORIZON, n_steps=N_UNET_LOOP, w=W,
                                 n_diffusion_steps_without_noise=N_TAIL, device=dev)
    res_u = loop_unet(x0, ep_noise[:N_UNET_LOOP])
    torch.cuda.synchronize()
    unet_launches = unet.launches
    if counts(unet, chain, ep1) != [(N_UNET_LOOP * n_total, 0), (0, 0), (0, 0)]:
        raise RuntimeError(f"BENCH_FUSED=1 path: counts (unet, chain, episode) "
                           f"{counts(unet, chain, ep1)}; expected {N_UNET_LOOP * n_total} "
                           f"U-Net launches and nothing else")
    ref_u = make_closed_loop(diffusion, unet.plain, inputs_stats, cond_stats, plant, cost,
                             horizon=HORIZON, n_steps=N_UNET_LOOP, w=W,
                             n_diffusion_steps_without_noise=N_TAIL, device=dev)(
        x0, ep_noise[:N_UNET_LOOP])
    torch.cuda.synchronize()
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        assert_close(f"BENCH_FUSED=1 {name}", getattr(res_u, name), getattr(ref_u, name), TRACK_TOL)
    log("unet-path", t0, f"{N_UNET_LOOP} replans: fused_unet launches={unet_launches}; tracks "
        f"equal the plain forward's to atol = rtol = {TRACK_TOL:.0e}")

    # 9. timing at the main paths' shapes
    t0 = time.perf_counter()
    ctx = contexts[0]
    chain_ms = cuda_ms(lambda: chain.kernel(ctx, noise), n=20, warmup=3)
    chain_plain_ms = cuda_ms(lambda: chain.plain(ctx, noise), n=5, warmup=1)
    args = unet_inputs[0]
    unet_ms = cuda_ms(lambda: unet.kernel(*args), n=200, warmup=10)
    unet_plain_ms = cuda_ms(lambda: unet.plain(*args), n=50, warmup=5)
    episode_ms = cuda_ms(lambda: ep1.kernel(x0, ep_noise), n=2, warmup=0)
    episode_plain_ms = cuda_ms(lambda: ep1.plain(x0, ep_noise), n=1, warmup=0)
    episode4_ms = cuda_ms(lambda: ep4.kernel(x0, noise4), n=2, warmup=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loop_kernel(x0, ep_noise)
    torch.cuda.synchronize()
    per_replan_hz = N_STEPS / (time.perf_counter() - t1)
    log("timing", t0, f"cfg_chain {chain_ms:.4f} ms (plain {chain_plain_ms:.4f}) per replan; "
        f"fused_unet {unet_ms:.4f} ms (plain {unet_plain_ms:.4f}) per pass at batch 2; "
        f"cfg_episode K=1 {episode_ms:.3f} ms per {N_STEPS}-replan episode = "
        f"{episode_ms / N_STEPS:.4f} ms per replan (plain {episode_plain_ms:.3f} ms); "
        f"K={K4} {episode4_ms:.3f} ms per {N_STEPS_K4} replans = "
        f"{episode4_ms / N_STEPS_K4:.4f} ms per replan; per-replan loop through cfg_chain "
        f"{per_replan_hz:.2f} replans/s")

    packed = chain.packed
    seg = lambda *prefixes: sum(math.prod(shape) for name, (_, shape) in packed.segments.items()
                                if name.split(".")[0] in prefixes)
    weights = packed.weights.numel()
    backbone_w = weights - seg("films", "final1x1")
    chain_weights = weights - seg("films")
    meta_n = packed.meta.numel()
    # cfg_chain: one replan, B = 1 (conv FLOPs of both row-sets at every step)
    chain_flops = packed.flops_per_pass * 2 * chain.n_samples * n_total
    chain_bytes = 4 * (chain_weights + meta_n + chain.films(ctx).numel() + noise.numel()
                       + chain.coefs.numel() + HORIZON)
    # fused_unet: one pass at batch 2, backbone only
    x_u = args[0]
    unet_flops = 2 * (packed.flops_per_pass - packed.flops_final_1x1)
    unet_bytes = 4 * (backbone_w + meta_n + unet.films(unet.model.conditioning(*args[1:])).numel()
                      + x_u.numel() + x_u.shape[0] * HORIZON * model.unet_input_dim)
    # cfg_episode: one 80-replan episode at K = 1, FiLM in the kernel included
    film_flops = 2 * 2 * int(packed.films_w.shape[1]) * sum(
        rb.cond_mlp[1].out_features for rb in model.res_blocks())
    ep_flops = N_STEPS * n_total * (chain_flops / n_total + film_flops)
    ep_bytes = 4 * (weights + meta_n + ep1.t_embs.numel() + ep_noise.numel() + ep1.coefs.numel()
                    + ep1.consts.numel() + 5 + (N_STEPS + 1) * 5 + N_STEPS * 3)
    rows = [
        {"name": "cfg_chain", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/cfg_chain.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_denoise.py:47",
         "launches": chain_launches, "max_abs_err": chain_err, "ms": chain_ms,
         "plain_ms": chain_plain_ms, **bound(chain_flops, chain_bytes), "library_ms": None,
         "per_replan_loop_hz": per_replan_hz},
        {"name": "fused_unet", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/fused_unet.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_unet.py:387",
         "launches": unet_launches, "max_abs_err": unet_err, "ms": unet_ms,
         "plain_ms": unet_plain_ms, **bound(unet_flops, unet_bytes), "library_ms": None,
         "launches_per_replan": unet_launches // N_UNET_LOOP},
        {"name": "cfg_episode", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/cfg_episode.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:410",
         "launches": episode_launches, "max_abs_err": ep_err, "ms": episode_ms,
         "plain_ms": episode_plain_ms, **bound(ep_flops, ep_bytes), "library_ms": None,
         "ms_per_replan": episode_ms / N_STEPS, "k4_ms_per_replan": episode4_ms / N_STEPS_K4,
         "closed_loop_control_hz": control_hz},
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
