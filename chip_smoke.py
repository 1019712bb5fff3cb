#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one card,
nvcc (``/usr/local/cuda``), the flagship weights in
``artifacts/flagship/ema_params.pkl`` and the distilled student's in
``artifacts/onpolicy_cartpole/`` (``student_1eval.pkl``, ``report.json``), and
writes nothing but the kernel builds under ``build/torch_kernels/``. Phases,
each printing one line with its own seconds:

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

The distilled student's path (``scripts/bench_deep_students.py``'s): the
1-eval student ``student_1eval.pkl`` on its times grid [23], with its
teacher's normalizer statistics (``data/teacher_stats.py``) and the
collection cost it is scored with. The grid [23] is one step with c1 = 1 and
c2 = 0, so every kernel check also runs the 3-step grid [23, 15, 7] on the
same weights, which exercises the affine update and the step loop.

9. student chain vs plain: the DDIM chain kernel against its plain version
   on three contexts at B = 1 and B = 4, on both grids; and on [23] against
   one pass of the U-Net pass kernel followed by the recon and clip.
10. the student's per-replan path: ``make_closed_loop`` with the DDIM chain
    kernel as its ``sample_override``, 80 replans from x0 at K = 1; the
    counts are set to 0 just before and read just after (80 chain launches,
    nothing else). The same loop through the plain chain must give the same
    tracks.
11. student episode: one launch of the DDIM episode kernel on phase 10's
    noise, against the plain episode and phase 10's tracks; on the 3-step
    grid against the plain episode; at K = 4 with selection_horizon 8, 8
    replans on both grids, the chosen candidate of every replan equal.
12. the student's sustained protocol: 10 dependent 80-replan K = 1 episodes
    through the episode kernel, one sync; the counts are set to 0 just
    before and read just after (10 episode launches, nothing else). It
    prints the replans per second as ``student_closed_loop_control_hz``.
13. student quality: 10 K = 1 episodes through the episode kernel from x0,
    each on the draw of a seeded ``torch.Generator``; each seed's cost over
    the expert's in ``report.json``, and their mean, which must be at most
    1.05.
14. timing: every kernel and its plain version by CUDA events at the main
    paths' shapes.

It then prints the ``kernels`` JSON line, the nvidia-smi line and, last, the
result line. Any failure raises, and the exit code is then not 0.

The flagship's normalizer statistics are the synthetic limits of
``bench.py`` (controls +-30, conditions +-10): the flagship dataset's own
are not in the repository.
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
from mpc_via_diffusion_model_tpu_torch.data.teacher_stats import teacher_stats
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_collect_cost,
                                                        cartpole_virtual_cost,
                                                        cartpole_virtual_swingup,
                                                        theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.models import load_flagship, load_student
from mpc_via_diffusion_model_tpu_torch.ops import _build
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import (make_fused_cfg_chain,
                                                                 make_fused_ddim_chain)
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import (make_fused_cfg_episode,
                                                                 make_fused_ddim_episode)
from mpc_via_diffusion_model_tpu_torch.ops.fused_unet import make_fused_unet

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "artifacts" / "flagship" / "ema_params.pkl"
STUDENT = ROOT / "artifacts" / "onpolicy_cartpole" / "student_1eval.pkl"
STUDENT_REPORT = ROOT / "artifacts" / "onpolicy_cartpole" / "report.json"
GRID, GRID3 = [23], [23, 15, 7]   # the 1-eval student's times grid; the 3-eval grid
N_QUALITY = 10             # seeds of the student's quality check
QUALITY_MEAN_MAX = 1.05    # mean cost over the expert's (report: 1.0064 over 10 seeds)
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
# The student's controls span its teacher's limits, +-3,381 on average
# (data/teacher_stats.py), so the same ~1e-6 in u_norm is ~1e-2 in u: its
# controls compare in the sampler's normalized units, u over the half-range,
# at CHAIN_TOL; its states and costs at TRACK_TOL (student_close).
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


def student_close(name: str, got: torch.Tensor, want: torch.Tensor, u_unit: torch.Tensor) -> float:
    """assert_close for a track of the student: controls (u_track,
    u_horizons) divided by ``u_unit`` at CHAIN_TOL, the rest at TRACK_TOL."""
    if name.split()[-1].startswith("u_"):
        return assert_close(name, got / u_unit, want / u_unit, CHAIN_TOL)
    return assert_close(name, got, want, TRACK_TOL)


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

    # 9. the student's DDIM chain kernel vs its plain version, both grids
    t0 = time.perf_counter()
    student = load_student(STUDENT, device=dev)
    s_ins, s_cond = (st.to(dev) for st in teacher_stats())
    u_unit = 0.5 * (s_ins.maxs - s_ins.mins)
    s_cost = cartpole_virtual_collect_cost()
    schain = make_fused_ddim_chain(student, schedule, GRID, n_samples=1, device=dev)
    spacked = schain.packed
    ddim = lambda times, b: make_fused_ddim_chain(spacked, schedule, times, n_samples=b, device=dev)
    sctx = normalize(s_cond, x0)[None]
    sx_init = torch.randn(schain.noise_shape, generator=gen, device=dev)
    schain_err = 0.0
    for times in (GRID, GRID3):
        for b in (1, 4):
            ch = schain if (times, b) == (GRID, 1) else ddim(times, b)
            ctxs = [sctx.expand(b, 5).contiguous()] + [
                torch.randn((b, 5), generator=gen, device=dev) for _ in range(2)]
            for ctx in ctxs:
                x_init = torch.randn(ch.noise_shape, generator=gen, device=dev)
                got, want = ch.kernel(ctx, x_init), ch.plain(ctx, x_init)
                torch.cuda.synchronize()
                schain_err = max(schain_err, assert_close(f"ddim_chain {times} B={b}", got, want,
                                                          CHAIN_TOL))
    # on [23] the chain is one recon step (c1 = 1, c2 = 0): one U-Net pass and the clip
    sunet = make_fused_unet(spacked, batch_size=1, device=dev)
    sra, srm = schain.coefs[0, 0], schain.coefs[0, 1]
    eps = sunet.kernel(sx_init, schain.t_eval[:1], sctx, torch.zeros((1, 1), device=dev))
    via_unet = torch.clamp(sra * sx_init - srm * eps, -1.0, 1.0)
    got = schain.kernel(sctx, sx_init)
    torch.cuda.synchronize()
    vs_unet = assert_close("ddim_chain vs fused_unet pass", got, via_unet, CHAIN_TOL)
    log("student-chain", t0, f"ddim_chain max |kernel - plain|={schain_err:.3e} over 3 contexts "
        f"x B in (1, 4) x grids {GRID} and {GRID3}; vs one fused_unet pass + recon + clip on "
        f"{GRID}: {vs_unet:.3e}; tol {CHAIN_TOL:.0e}")

    # 10. the student's per-replan path: 80 replans through the DDIM chain kernel
    t0 = time.perf_counter()
    wrappers = [chain, unet, ep1, ep4, schain, sunet]
    s_loop = lambda sampler: make_closed_loop(
        diffusion, student, s_ins, s_cond, plant, s_cost, horizon=HORIZON, n_steps=N_STEPS,
        sample_override=sampler, noise_shape=schain.noise_shape, device=dev)
    s_noise = torch.randn((N_STEPS,) + schain.noise_shape, generator=gen, device=dev)
    reset(*wrappers)
    s_res = s_loop(schain)(x0, s_noise)
    torch.cuda.synchronize()
    s_chain_launches = schain.launches
    if counts(*wrappers) != [(0, 0)] * 4 + [(N_STEPS, 0), (0, 0)]:
        raise RuntimeError(f"student per-replan path: counts {counts(*wrappers)}; expected "
                           f"{N_STEPS} ddim_chain launches and nothing else")
    s_ref = s_loop(schain.plain)(x0, s_noise)
    torch.cuda.synchronize()
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        student_close(f"student loop {name}", getattr(s_res, name), getattr(s_ref, name), u_unit)
    # the controls' gap in u's own units and in u_norm's, the reading behind comparing them
    # normalized: fp32 rounding in u_norm, scaled by the teacher's half-range
    du = (s_res.u_horizons.double() - s_ref.u_horizons.double()).abs()
    du_max, du_norm_max = du.max().item(), (du / u_unit.double()).max().item()
    log("student-per-replan-path", t0, f"{N_STEPS} replans: ddim_chain launches="
        f"{s_chain_launches}; total cost {s_res.stage_costs.sum().item():.6f}; equal to the plain "
        f"chain's to atol = rtol = {TRACK_TOL:.0e} (controls {CHAIN_TOL:.0e} in normalized units); "
        f"controls max |du|={du_max:.3e}, max |du_norm|={du_norm_max:.3e} over half-range "
        f"{u_unit.max().item():.3f}, max |u|={s_ref.u_horizons.abs().max().item():.3f}; "
        f"x_final={[round(v, 6) for v in s_res.x_track[-1].tolist()]}")

    # 11. the student's episode kernel, K = 1 on phase 10's noise, and K = 4
    t0 = time.perf_counter()
    sepisode = lambda times, k, n_steps, sel_h=None: make_fused_ddim_episode(
        spacked, schedule, times, s_ins, s_cond, plant, s_cost, n_steps=n_steps, n_candidates=k,
        selection_horizon=sel_h, device=dev)
    sep1 = sepisode(GRID, 1, N_STEPS)
    sep_err, s_chosen = 0.0, []
    for times in (GRID, GRID3):
        for k, n_steps, sel_h in ((1, N_STEPS, None), (K4, N_STEPS_K4, SEL_H)):
            ep = sep1 if (times, k) == (GRID, 1) else sepisode(times, k, n_steps, sel_h)
            nz = s_noise if ep is sep1 else torch.randn(ep.noise_shape, generator=gen, device=dev)
            got, want = ep.kernel(x0, nz), ep.plain(x0, nz)
            torch.cuda.synchronize()
            for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
                sep_err = max(sep_err, student_close(f"ddim_episode {times} K={k} {name}", g, w_,
                                                     u_unit))
            if not torch.equal(got[3], want[3]):
                raise RuntimeError(f"ddim_episode {times} K={k}: chosen {got[3].tolist()} vs "
                                   f"plain {want[3].tolist()}")
            if k > 1:
                s_chosen.append(got[3].tolist())
            if ep is sep1:
                s_vs_loop = max(
                    student_close(f"ddim_episode vs per-replan loop {name}", g,
                                  getattr(s_res, name), u_unit)
                    for name, g in zip(("x_track", "u_track", "stage_costs"), got))
    log("student-episode", t0, f"{N_STEPS} replans in one launch on {GRID} and {GRID3}: max "
        f"|kernel - plain|={sep_err:.3e}, max |episode - per-replan loop|={s_vs_loop:.3e}, "
        f"atol = rtol = {TRACK_TOL:.0e} (controls {CHAIN_TOL:.0e} in normalized units); K={K4}, "
        f"selection_horizon={SEL_H}, {N_STEPS_K4} replans: "
        f"chosen {s_chosen} in both")

    # 12. the student's sustained protocol through the episode kernel
    t0 = time.perf_counter()
    wrappers.append(sep1)
    reset(*wrappers)
    x_cur = x0
    t1 = time.perf_counter()
    for _ in range(N_CHAIN):
        ep_nz = torch.randn(sep1.noise_shape, generator=gen, device=dev)
        x_tr, _, _ = sep1(x_cur, ep_nz)
        x_cur = x_tr[-1]
    torch.cuda.synchronize()
    s_sustained_s = time.perf_counter() - t1
    s_episode_launches = sep1.launches
    if counts(*wrappers) != [(0, 0)] * 6 + [(N_CHAIN, 0)]:
        raise RuntimeError(f"student protocol: counts {counts(*wrappers)}; expected {N_CHAIN} "
                           f"ddim_episode launches and nothing else")
    if not torch.isfinite(x_cur).all():
        raise RuntimeError("student protocol: non-finite final state")
    s_control_hz = N_CHAIN * N_STEPS / s_sustained_s
    print(json.dumps({"metric": "student_closed_loop_control_hz", "value": s_control_hz,
                      "unit": "Hz", "protocol": "sustained_800step_dependent_chain",
                      "times": GRID, "episode_launches": s_episode_launches,
                      "seconds": s_sustained_s}), flush=True)
    log("student-protocol", t0, f"{N_CHAIN} dependent episodes of {N_STEPS} replans: "
        f"{s_sustained_s:.3f}s, {s_control_hz:.2f} replans/s; ddim_episode launches="
        f"{s_episode_launches}; x_final={[round(v, 6) for v in x_cur.tolist()]}")

    # 13. the student's control quality against the report's expert
    t0 = time.perf_counter()
    expert_cost = json.loads(STUDENT_REPORT.read_text())["expert_cost"]
    ratios = []
    for seed in range(N_QUALITY):
        g = torch.Generator(device=dev).manual_seed(seed)
        _, _, costs = sep1(x0, torch.randn(sep1.noise_shape, generator=g, device=dev))
        ratios.append(costs.sum().item() / expert_cost)
    if not all(math.isfinite(r) for r in ratios):
        raise RuntimeError(f"student quality: non-finite cost ratios {ratios}")
    ratio_mean, ratio_max = sum(ratios) / len(ratios), max(ratios)
    if ratio_mean > QUALITY_MEAN_MAX:
        raise RuntimeError(f"student quality: mean cost ratio {ratio_mean:.5f} > {QUALITY_MEAN_MAX}")
    log("student-quality", t0, f"{N_QUALITY} seeds, K=1, {N_STEPS} replans, cost over expert "
        f"{expert_cost}: {[round(r, 5) for r in ratios]}; mean {ratio_mean:.5f}, max "
        f"{ratio_max:.5f} (at most {QUALITY_MEAN_MAX} on the mean)")

    # 14. timing at the main paths' shapes
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
    schain_ms = cuda_ms(lambda: schain.kernel(sctx, sx_init), n=200, warmup=10)
    schain_plain_ms = cuda_ms(lambda: schain.plain(sctx, sx_init), n=50, warmup=5)
    sep_ms = cuda_ms(lambda: sep1.kernel(x0, s_noise), n=5, warmup=1)
    sep_plain_ms = cuda_ms(lambda: sep1.plain(x0, s_noise), n=1, warmup=0)
    sep3 = sepisode(GRID3, 1, N_STEPS)
    sep3_ms = cuda_ms(lambda: sep3.kernel(x0, s_noise), n=3, warmup=1)
    sep4 = sepisode(GRID, K4, N_STEPS_K4, SEL_H)
    s_noise4 = torch.randn(sep4.noise_shape, generator=gen, device=dev)
    sep4_ms = cuda_ms(lambda: sep4.kernel(x0, s_noise4), n=5, warmup=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loop_kernel(x0, ep_noise)
    torch.cuda.synchronize()
    per_replan_hz = N_STEPS / (time.perf_counter() - t1)
    s_loop_kernel = s_loop(schain)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s_loop_kernel(x0, s_noise)
    torch.cuda.synchronize()
    s_per_replan_hz = N_STEPS / (time.perf_counter() - t1)
    log("timing", t0, f"cfg_chain {chain_ms:.4f} ms (plain {chain_plain_ms:.4f}) per replan; "
        f"fused_unet {unet_ms:.4f} ms (plain {unet_plain_ms:.4f}) per pass at batch 2; "
        f"cfg_episode K=1 {episode_ms:.3f} ms per {N_STEPS}-replan episode = "
        f"{episode_ms / N_STEPS:.4f} ms per replan (plain {episode_plain_ms:.3f} ms); "
        f"K={K4} {episode4_ms:.3f} ms per {N_STEPS_K4} replans = "
        f"{episode4_ms / N_STEPS_K4:.4f} ms per replan; per-replan loop through cfg_chain "
        f"{per_replan_hz:.2f} replans/s")
    log("timing-student", t0, f"ddim_chain {GRID} {schain_ms:.4f} ms (plain {schain_plain_ms:.4f}) "
        f"per replan; ddim_episode {GRID} K=1 {sep_ms:.3f} ms per {N_STEPS}-replan episode = "
        f"{sep_ms / N_STEPS:.4f} ms per replan (plain {sep_plain_ms:.3f} ms); {GRID3} K=1 "
        f"{sep3_ms / N_STEPS:.4f} ms per replan; {GRID} K={K4} {sep4_ms / N_STEPS_K4:.4f} ms per "
        f"replan; per-replan loop through ddim_chain {s_per_replan_hz:.2f} replans/s")

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
    # ddim_chain: one replan on the student's grid, B = 1 (one row-set per step); the student
    # has the flagship's architecture, so the weight counts above are its own
    if spacked.weights.numel() != weights or spacked.meta.numel() != meta_n:
        raise RuntimeError("the student's packed U-Net differs in size from the flagship's")
    schain_flops = spacked.flops_per_pass * schain.n_samples * schain.n_total
    schain_bytes = 4 * (chain_weights + meta_n + schain.films(sctx).numel() + sx_init.numel()
                        + schain.coefs.numel() + HORIZON)
    # ddim_episode: one 80-replan episode at K = 1, the FiLM of one group in the kernel included
    sep_flops = N_STEPS * sep1.n_total * (spacked.flops_per_pass + film_flops / 2)
    sep_bytes = 4 * (weights + meta_n + sep1.t_embs.numel() + s_noise.numel() + sep1.coefs.numel()
                     + sep1.consts.numel() + 5 + (N_STEPS + 1) * 5 + N_STEPS * 3)
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
        {"name": "ddim_chain", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/ddim_chain.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_denoise.py:164",
         "launches": s_chain_launches, "max_abs_err": schain_err, "ms": schain_ms,
         "plain_ms": schain_plain_ms, **bound(schain_flops, schain_bytes), "library_ms": None,
         "times": GRID, "per_replan_loop_hz": s_per_replan_hz},
        {"name": "ddim_episode", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/ddim_episode.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:142",
         "launches": s_episode_launches, "max_abs_err": sep_err, "ms": sep_ms,
         "plain_ms": sep_plain_ms, **bound(sep_flops, sep_bytes), "library_ms": None,
         "times": GRID, "ms_per_replan": sep_ms / N_STEPS,
         "grid3_ms_per_replan": sep3_ms / N_STEPS, "k4_ms_per_replan": sep4_ms / N_STEPS_K4,
         "student_closed_loop_control_hz": s_control_hz, "cost_ratio_mean": ratio_mean,
         "cost_ratio_max": ratio_max},
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
