#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one card,
nvcc (``/usr/local/cuda``), the flagship weights in
``artifacts/flagship/ema_params.pkl``, the distilled student's in
``artifacts/onpolicy_cartpole/`` (``student_1eval.pkl``, ``report.json``) and
the LMPC parity workload's in ``artifacts/flagship_lmpc/`` (``ema_params.pkl``,
``report.json``), and writes nothing but the kernel builds under
``build/torch_kernels/``. Phases,
each printing one line with its own seconds:

1. device: the card's name, the device count, and nvidia-smi's name and
   power limit. Without a card the script exits non-zero and prints no result.
2. build: nvcc on every ``ops/csrc/*.cu`` for sm_90a, one process per
   source, all started together, with each one's wall time and its
   ``-Xptxas -v`` register, shared-memory and spill report; the five
   cluster kernels' registers and spills again on one line (the CFG chain,
   the U-Net pass, the CFG episode, the DDIM chain and the DDIM episode:
   clusters of 8 CTAs on ``unet_body_cluster.cuh``), each with the cluster
   occupancy query (``cudaOccupancyMaxActiveClusters``) at its shared memory
   at full width: the chains' and the pass's plan, the episodes' for K = 1
   and K = 4; the same for the bf16 entries of the CFG chain and the CFG
   episode (``cfg_chain_bf16``, ``cfg_episode_bf16``: the __nv_bfloat16
   instantiations of ``cfg_chain.cu`` and ``cfg_episode.cu``) and for the
   CFG episode's linear cart-pole entry (``cfg_episode_lmpc``) at K = 1 and
   K = 8 on the LMPC model; and the conv
   kernel's registers and spills (one CTA per
   GroupNorm group and batch chunk on ``mma.sync`` tf32 tiles in 3xTF32,
   one instantiation per accumulator tiles a warp holds: 1, 2, 4, 8).
3. kernel vs plain: the CFG chain kernel (one cluster per sample) on three
   contexts, and the U-Net pass kernel (one cluster per batch row) on three
   (x, t, context, mask) draws at batch 2, each against its plain PyTorch
   version on the flagship weights at full width.
4. per-replan path (``BENCH_FUSED=chain``): the flagship cart-pole CFG
   closed loop, 80 replans from x0 = [0, 0, 3.0, 0, theta*(3.0)], with the
   chain kernel as the sampler; the counts are set to 0 just before and read
   just after. The first 20 replans through the plain chain on the same
   noise must give the same tracks.
5. episode, K = 1: the whole 80-replan loop as one launch of the episode
   kernel (one cluster of 8 CTAs that splits the U-Net body by GroupNorm
   group), on phase 4's noise, against the plain episode and against
   phase 4's tracks; exactly one launch.
6. episode, K = 4, selection_horizon 8: 8 replans against the plain
   episode, the chosen candidate of every replan included; one launch.
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

9. student chain vs plain: the DDIM chain kernel (one cluster per sample)
   against its plain version on three contexts at B = 1 and B = 4, on both
   grids; and on [23] against one pass of the U-Net pass kernel followed by
   the recon and clip.
10. the student's per-replan path: ``make_closed_loop`` with the DDIM chain
    kernel as its ``sample_override``, 80 replans from x0 at K = 1; the
    counts are set to 0 just before and read just after (80 chain launches,
    nothing else). The same loop through the plain chain must give the same
    tracks.
11. student episode: one launch of the DDIM episode kernel (one cluster of 8
    CTAs on the body's one row-set) on phase 10's
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
    paths' shapes; the U-Net pass and the DDIM chain both by their launch
    alone (``_launch`` on prepared tensors) and by the wrapper's whole call
    (``FusedUnet.forward``, ``FusedDdimChain.__call__``), which splits off
    the host's share; the DDIM chain also on [23, 15, 7] and at B = 4; the
    per-replan loops' and the ``BENCH_FUSED=1`` loop's replans per second.

The fused conv block and the port's ``bench_kernels``, the path that runs it:

15. conv: the fused Conv1d + GroupNorm + Mish kernel against its plain
    version at ``bench_kernels``' six shapes, with and without a FiLM
    pre-bias, b, gamma and beta drawn, and once at eps 1e-3; the counts are
    read back exactly.
16. ``bench_kernels --quick``: every row of the port's kernel benchmark (the
    conv rows, one U-Net pass, both chains, the CFG episode), each kernel
    within its tolerance of its plain twin; the counts are set to 0 just
    before and read just after.
17. flagship quality: ``scripts/flagship_parity``'s protocol on the card, 10
    torch-seeded K = 1 loops of 80 replans through the CFG chain kernel with
    the flagship dataset's statistics (``data/flagship_stats.py``): the mean
    closed-loop cost over the expert's in ``artifacts/flagship/report.json``
    at most 1.01 and all 10 runs swinging left, the report's modality; the
    horizon cost and the parity against the stored expert tracks printed
    beside the report's. Then the same 10 seeds through the CFG episode
    kernel (``flagship_parity.run_episode_quality``, 10 launches and nothing
    else) under the same gate.
18. timing of the conv kernel at the six shapes: the launch alone as the
    device sees it (100 launches of ``FusedConv1dGnMish._launch`` on
    prepared tensors captured into a CUDA graph, the graph replayed between
    CUDA events, ``scripts/conv_timing.py``'s ``graph_ms``), the whole call
    (``kernel``, by CUDA events), the kernel's device time per launch from
    ``torch.profiler`` (or none where it records none), its plain version,
    the three PyTorch calls that compute the same block (``torch_seq``) and
    the bound, with the bound's share of the launch alone.

bf16 weights (``weights_dtype=torch.bfloat16``, ``bench.py``'s ``BENCH_BF16=1``)
and the port's bench:

19. bf16: the bf16 entries against their plain bf16 versions
    (``models/bf16.py``). A kernel and its plain version sum in other
    orders, so now and then an activation rounds to the other bf16
    neighbour in one of them; over 30 steps such flips cascade until two
    correct bf16 versions part by about as much as bf16 parts from fp32. So
    the gate is at one U-Net pass (T = 1, no tail): the chain over 64
    samples in one launch, the episode over 64 replans at K = 1 and 8 at
    K = 4 (choices equal), the per-sample max |kernel - plain| at most 5e-6
    at the median and 1e-3 at the worst (``ONE_PASS_*``). At full depth the
    chain on phase 3's three contexts and the episode on phase 4's noise
    over 80 replans are held to JAX's own bound of bf16 against fp32, 8e-2,
    and their differences printed; K = 4 over 8 replans prints both
    versions' choices.
20. the flagship's quality through the bf16 episode, phase 17's protocol:
    recorded, not gated (no bf16 report exists).
21. the port's bench: ``python3 -m mpc_via_diffusion_model_tpu_torch.bench``
    in a process of its own with ``bench.py``'s counts (the default mode,
    61 episode launches), its last line parsed and its keys checked; then
    ``bench.run`` in this process for the episode in bf16 (one repetition
    per measure) and for ``chain``, ``chain`` in bf16 and ``1`` (two
    episodes each), each launch count exact. Then the bf16 entries' times.

The LMPC parity workload (``scripts/lmpc_parity.py``: the linear cart-pole
at horizon 8, context 4, against its LQR expert; the committed weights and
``data/lmpc_stats.py``):

22. LMPC kernels against plain: the CFG chain kernel at H = 8 on three
    contexts at B = 1 and one at B = 8 (1e-4), and the episode's
    ``cfg_episode_lmpc`` entry from the sweep's first state, 10 replans at
    K = 1 and 4 at K = 8 (tracks 1e-3; choices equal wherever the plain
    version's best two candidate scores are more than 1e-5 apart, each
    near-tie printed with both scores and both choices); one launch each.
23. LMPC parity: ``lmpc_parity``'s episode route over the 16 sweep states,
    50 replans each. n = 1 (16 launches and nothing else): every track
    finite, each state's u_l1 within 1e-3 + 1% of the JAX package's loop on
    the CPU (``LMPC_U_L1``) and the mean within 1% of its mean, printed
    beside it and ``report.json``'s. K = 8 (one launch per state; reported,
    not gated; over the first 8 states, to keep phases 22-23 within 45 s):
    the same numbers beside the report's (over 16 states), the choices
    other than candidate 0, and the spread of the 8 candidates' first
    controls (the chain kernel at B = 8 on the first 2 states' replans). The chain
    route over the first 2 states (100 chain launches) gives the episode's
    tracks within 1e-3. Then the times of the episode entry at K = 1 and 8
    and of the chain at H = 8.

It then prints the ``kernels`` JSON line (rows 1 and 3 carry their bf16
entries under ``bf16``, row 1 its H = 8 times under ``h8``, and
``cfg_episode_lmpc`` has a row of its own as a further entry of kernel 3),
the nvidia-smi line and, last, the result line. Any failure raises, and the
exit code is then not 0.

Phases 3-8 and ``bench_kernels``' episode row run the flagship with the
synthetic limits of ``bench.py`` (controls +-30, conditions +-10); phase 17
with its dataset's own.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from mpc_via_diffusion_model_tpu_torch import bench as port_bench
from mpc_via_diffusion_model_tpu_torch.control import make_closed_loop
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import (NormalizerStats, lmpc_stats, normalize,
                                                    unnormalize)
from mpc_via_diffusion_model_tpu_torch.data.lmpc_stats import LMPC_U_L1, LMPC_U_L1_SUMMARY
from mpc_via_diffusion_model_tpu_torch.data.teacher_stats import teacher_stats
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_lmpc, cartpole_lmpc_cost,
                                                        cartpole_virtual_collect_cost,
                                                        cartpole_virtual_cost,
                                                        cartpole_virtual_swingup,
                                                        theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.models import load_flagship, load_lmpc, load_student
from mpc_via_diffusion_model_tpu_torch.ops import _build, fused_conv1d_gn_mish
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import (
    cfg_chain_bf16_max_active_clusters, cfg_chain_max_active_clusters,
    ddim_chain_max_active_clusters, make_fused_cfg_chain, make_fused_ddim_chain)
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import (
    cfg_episode_bf16_max_active_clusters, cfg_episode_lmpc_max_active_clusters,
    cfg_episode_max_active_clusters, ddim_episode_max_active_clusters, make_fused_cfg_episode,
    make_fused_ddim_episode)
from mpc_via_diffusion_model_tpu_torch.ops.fused_unet import (fused_unet_max_active_clusters,
                                                              make_fused_unet)
from mpc_via_diffusion_model_tpu_torch.ops.unet_pack import CLUSTER, pack_unet
from mpc_via_diffusion_model_tpu_torch.scripts import (bench_kernels, conv_timing, flagship_parity,
                                                       lmpc_parity)
from mpc_via_diffusion_model_tpu_torch.scripts.conv_timing import cuda_ms

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "artifacts" / "flagship" / "ema_params.pkl"
STUDENT = ROOT / "artifacts" / "onpolicy_cartpole" / "student_1eval.pkl"
STUDENT_REPORT = ROOT / "artifacts" / "onpolicy_cartpole" / "report.json"
LMPC = ROOT / "artifacts" / "flagship_lmpc" / "ema_params.pkl"
GRID, GRID3 = [23], [23, 15, 7]   # the 1-eval student's times grid; the 3-eval grid
N_QUALITY = 10             # seeds of the student's quality check
QUALITY_MEAN_MAX = 1.05    # mean cost over the expert's (report: 1.0064 over 10 seeds)
# The flagship's mean cost over its expert's (report: 784,747.4 / 784,750.6 over 10 JAX seeds)
FLAGSHIP_MEAN_MAX, FLAGSHIP_MODALITY = 1.01, {"left": 10, "right": 0}
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
# The conv block, kernel vs plain: bench_kernels' tolerance, the JAX suite's for kernels
CONV_TOL = bench_kernels.KERNEL_TOL
CONV_SHAPES = bench_kernels.CONV_SHAPES
# Tracks of closed loops, kernel vs plain: per-replan differences of ~1e-6
# in u_norm (x30 after unnormalizing) pass through up to 80 plant steps.
TRACK_TOL = 1e-3
# The student's controls span its teacher's limits, +-3,381 on average
# (data/teacher_stats.py), so the same ~1e-6 in u_norm is ~1e-2 in u: its
# controls compare in the sampler's normalized units, u over the half-range,
# at CHAIN_TOL; its states and costs at TRACK_TOL (student_close).
# bf16 weights (phase 19). A kernel and its plain version sum in other orders, so an
# activation within that difference of a midpoint between two bf16 numbers rounds one way in
# one and the other way in the other. One such flip moves a pass by up to ~1e-4 in u_norm; over
# 30 steps the flips cascade, and two correct bf16 versions then part by as much as bf16 parts
# from fp32 (on the CPU the plain bf16 chain in fp32 against float64 at T = 25 + 5, 64 samples:
# 1.1e-3 median, 3.1e-3 max; bf16 against fp32 itself 0.8e-3 median). So the bf16 kernels are
# gated at one U-Net pass (T = 1, no tail), over N_ONE_PASS samples or replans: a correct
# kernel agrees to fp32 rounding wherever no flip happened, which on the CPU was most of them
# (median 1.9e-7, 23% of samples flipped, max 8e-5), while one rounding point left out (the
# final 1x1 conv's input) moved every sample (median 2.5e-5). Full depth is gated at JAX's own
# bound of bf16 against fp32 (tests/test_fused_denoise.py:59-77) and otherwise recorded.
N_ONE_PASS = 64
ONE_PASS_MEDIAN_MAX, ONE_PASS_MAX = 5e-6, 1e-3
BF16_VS_FP32 = 8e-2
U_HALF_RANGE = 30.0        # bench.py's control limits +-30: u_norm = u / 30
BENCH_EPISODE_KEYS = ["metric", "value", "unit", "vs_baseline", "pipelined_hz", "protocol"]
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# The LMPC parity workload (phases 22-23): horizon 8, context 4, the linear cart-pole
LMPC_H, K8 = 8, 8
N_LMPC_EP, N_LMPC_EP8 = 10, 4   # replans of phase 22's episode checks at K = 1 and K = 8
# sweep states of phase 23's K = 8 run (reported, not gated): over all 16 the K = 8 run alone
# took 32.5 s and phases 22-23 44.4 s on the H100, at the 45 s they may take
N_LMPC_STATES_K8 = 8
N_LMPC_CHAIN_STATES = 2         # sweep states run through the chain route too
# Per state, u_l1 (a sum of 50 |du|) within 1e-3 + 1% of the JAX package's on the CPU; the mean
# within 1% of the JAX mean. Choices at K = 8 are compared where the plain version's best two
# scores are more than 1e-5 apart (relative): the candidates hardly differ, and nearer scores
# than that can swap under the fp32 difference between kernel and plain.
LMPC_ABS, LMPC_REL, NEAR_TIE = 1e-3, 0.01, 1e-5


def log(phase: str, t0: float, msg: str) -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.3f}s {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


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


def one_pass_gate(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """The bf16 kernels' gate at one U-Net pass: per sample (the first axis) the max |got -
    want|, whose median must be at most ONE_PASS_MEDIAN_MAX and whose max at most ONE_PASS_MAX;
    returns the median, the max and the share of samples past 1e-5 (flipped roundings)."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{name}: non-finite values")
    per = (got.double() - want.double()).abs().flatten(1).max(dim=1).values.tolist()
    out = {"median": statistics.median(per), "max": max(per),
           "flipped_share": sum(v > 1e-5 for v in per) / len(per), "n": len(per)}
    if not (out["median"] <= ONE_PASS_MEDIAN_MAX and out["max"] <= ONE_PASS_MAX):
        raise RuntimeError(f"{name}: per-sample max |kernel - plain| median {out['median']:.3e} "
                           f"(at most {ONE_PASS_MEDIAN_MAX:.0e}), max {out['max']:.3e} (at most "
                           f"{ONE_PASS_MAX:.0e})")
    return out


def fmt_gate(g: dict) -> str:
    return (f"median {g['median']:.3e}, max {g['max']:.3e}, {100 * g['flipped_share']:.1f}% of "
            f"{g['n']} past 1e-5 (gate: median <= {ONE_PASS_MEDIAN_MAX:.0e}, max <= "
            f"{ONE_PASS_MAX:.0e})")


def near_tie(scores: torch.Tensor) -> bool:
    """Whether the best two candidate scores differ by at most NEAR_TIE, relative."""
    best2 = torch.sort(scores.double()).values[:2]
    return bool(best2[1] - best2[0] <= NEAR_TIE * best2[0].abs())


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
    # the cluster kernels: their registers and spills (from cuobjdump when the build was reused),
    # and how many of their clusters fit at once at full width
    packed_cpu = pack_unet(load_flagship(FLAGSHIP, device="cpu"), "cpu")
    ep_smem = [packed_cpu.episode_smem_bytes(k) for k in (1, K4)]
    lmpc_smem = [pack_unet(load_lmpc(LMPC, device="cpu"), "cpu").episode_smem_bytes(k)
                 for k in (1, K8)]
    cluster_kernels = {  # entry: (occupancy query, shared memory per CTA of each launch shape)
        "cfg_chain": (cfg_chain_max_active_clusters, [packed_cpu.smem_bytes]),
        "cfg_chain_bf16": (cfg_chain_bf16_max_active_clusters, [packed_cpu.smem_bytes]),
        "fused_unet": (fused_unet_max_active_clusters, [packed_cpu.smem_bytes]),
        "cfg_episode": (cfg_episode_max_active_clusters, ep_smem),
        "cfg_episode_bf16": (cfg_episode_bf16_max_active_clusters, ep_smem),
        "ddim_chain": (ddim_chain_max_active_clusters, [packed_cpu.smem_bytes]),
        "ddim_episode": (ddim_episode_max_active_clusters, ep_smem),
        "cfg_episode_lmpc": (cfg_episode_lmpc_max_active_clusters, lmpc_smem)}
    def resources(entry: str):
        """(registers, spills) of each kernel of an entry, from nvcc's report or, when the
        build was reused, cuobjdump's: the bf16 entries (``<source>_bf16``) are their
        library's __nv_bfloat16 instantiation, every other entry its library's other
        kernels."""
        name, bf16 = entry.removesuffix("_bf16"), entry.endswith("_bf16")
        report = built[name].report or subprocess.run(
            [str(Path(_build._nvcc()).with_name("cuobjdump")), "--dump-resource-usage",
             str(built[name].path)], capture_output=True, text=True, timeout=60).stdout
        marks = list(re.finditer(r"Compiling entry function '(\w+)'|Function (\w+):", report))
        regs, spills = [], []
        for mark, nxt in zip(marks, marks[1:] + [None]):
            if ("I13__nv_bfloat16E" in (mark.group(1) or mark.group(2))) != bf16:
                continue
            part = report[mark.end():nxt.start() if nxt else len(report)]
            regs += [int(a or b) for a, b in re.findall(r"Used (\d+) registers|REG:(\d+)", part)]
            spills += [[int(v) for v in t if v] for t in re.findall(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads|LOCAL:(\d+)", part)]
        if not regs or not spills:
            raise RuntimeError(f"{entry}: no register or spill report in\n{report}")
        return regs, spills

    cluster_info, lines = {}, []
    for name, (query, smems) in cluster_kernels.items():
        regs, spills = resources(name)
        slots = [query(b) for b in smems]
        if not all(slots):
            raise RuntimeError(f"{name}: no cluster of {CLUSTER} CTAs fits on the card: {slots} at "
                               f"{smems} B per CTA")
        cluster_info[name] = {"registers": regs, "spill_bytes": spills, "clusters_fit": slots,
                              "smem_bytes_per_cta": smems}
        lines.append(f"{name} registers {regs}, spill stores and loads (or local bytes) {spills}, "
                     f"clusters of {CLUSTER} CTAs that fit at once "
                     + ", ".join(f"{n} at {b} B per CTA" for n, b in zip(slots, smems)))
    # the conv kernel: one instantiation per accumulator tiles per warp (1, 2, 4, 8)
    conv_regs, conv_spills = resources("fused_conv")
    conv_info = {"registers": conv_regs, "spill_bytes": conv_spills}
    lines.append(f"fused_conv registers {conv_regs}, spill stores and loads (or local bytes) "
                 f"{conv_spills}")
    log("build", t0, f"{len(built)} libraries; " + "; ".join(lines)
        + f" (the chains' and the pass's plan at every batch; episodes at K = 1 and K = {K4}, "
        f"cfg_episode_lmpc at K = 1 and K = {K8} on the LMPC model; the _bf16 entries are the "
        "bf16 instantiations of cfg_chain.cu and cfg_episode.cu, cfg_episode_lmpc is "
        "cfg_episode.cu compiled for the linear cart-pole)")

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
    if ep1.launches != 1:
        raise RuntimeError(f"episode K=1: {ep1.launches} launches for one episode")
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
    if ep4.launches != 1:
        raise RuntimeError(f"episode K={K4}: {ep4.launches} launches for one episode")
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
    # the U-Net pass: the launch alone on prepared tensors, and the wrapper's whole call
    u_films = unet.films(unet.model.conditioning(*args[1:])).contiguous()
    u_y = torch.empty((2, HORIZON, model.unet_input_dim), device=dev)
    unet_ms = cuda_ms(lambda: unet._launch(unet.cluster.weights, u_films, args[0], u_y), n=200,
                      warmup=10)
    unet_call_ms = cuda_ms(lambda: unet(*args), n=200, warmup=10)
    unet_plain_ms = cuda_ms(lambda: unet.plain(*args), n=50, warmup=5)
    episode_ms = cuda_ms(lambda: ep1.kernel(x0, ep_noise), n=5, warmup=1)
    episode_plain_ms = cuda_ms(lambda: ep1.plain(x0, ep_noise), n=1, warmup=0)
    episode4_ms = cuda_ms(lambda: ep4.kernel(x0, noise4), n=5, warmup=1)
    # the DDIM chain: the launch alone and the whole call on [23], B = 1; the launch alone on
    # [23, 15, 7] and at B = 4 (clusters side by side)
    def launch_alone(ch, ctx_, x_):
        films, out = ch.films(ctx_).contiguous(), torch.empty(ch.noise_shape, device=dev)
        return lambda: ch._launch(ch.cluster.weights, films, x_, out)

    schain_ms = cuda_ms(launch_alone(schain, sctx, sx_init), n=200, warmup=10)
    schain_call_ms = cuda_ms(lambda: schain(sctx, sx_init), n=200, warmup=10)
    schain_plain_ms = cuda_ms(lambda: schain.plain(sctx, sx_init), n=50, warmup=5)
    schain4 = ddim(GRID, K4)
    x4 = torch.randn(schain4.noise_shape, generator=gen, device=dev)
    schain3_ms = cuda_ms(launch_alone(ddim(GRID3, 1), sctx, sx_init), n=100, warmup=5)
    schain4_ms = cuda_ms(launch_alone(schain4, sctx.expand(K4, 5), x4), n=200, warmup=10)
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
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loop_unet(x0, ep_noise[:N_UNET_LOOP])
    torch.cuda.synchronize()
    unet_loop_hz = N_UNET_LOOP / (time.perf_counter() - t1)
    log("timing", t0, f"cfg_chain {chain_ms:.4f} ms (plain {chain_plain_ms:.4f}) per replan; "
        f"fused_unet {unet_ms:.4f} ms launch alone, {unet_call_ms:.4f} ms whole call (plain "
        f"{unet_plain_ms:.4f}) per pass at batch 2; BENCH_FUSED=1 loop {unet_loop_hz:.2f} "
        f"replans/s; "
        f"cfg_episode K=1 {episode_ms:.3f} ms per {N_STEPS}-replan episode = "
        f"{episode_ms / N_STEPS:.4f} ms per replan (plain {episode_plain_ms:.3f} ms); "
        f"K={K4} {episode4_ms:.3f} ms per {N_STEPS_K4} replans = "
        f"{episode4_ms / N_STEPS_K4:.4f} ms per replan; per-replan loop through cfg_chain "
        f"{per_replan_hz:.2f} replans/s")
    log("timing-student", t0, f"ddim_chain {GRID} {schain_ms:.4f} ms launch alone, "
        f"{schain_call_ms:.4f} ms whole call (plain {schain_plain_ms:.4f}) per replan, {GRID3} "
        f"{schain3_ms:.4f} ms, {GRID} B={K4} {schain4_ms:.4f} ms launch alone; ddim_episode "
        f"{GRID} K=1 {sep_ms:.3f} ms per {N_STEPS}-replan episode = "
        f"{sep_ms / N_STEPS:.4f} ms per replan (plain {sep_plain_ms:.3f} ms); {GRID3} K=1 "
        f"{sep3_ms / N_STEPS:.4f} ms per replan; {GRID} K={K4} {sep4_ms / N_STEPS_K4:.4f} ms per "
        f"replan; per-replan loop through ddim_chain {s_per_replan_hz:.2f} replans/s")

    # 15. the fused conv block against its plain version at the bench's six shapes
    t0 = time.perf_counter()
    conv_inputs, conv_err = {}, 0.0
    reset(fused_conv1d_gn_mish)
    for bsz, h, cin, cout in CONV_SHAPES:
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        c_args = (rnd(bsz, h, cin), rnd(5, cin, cout) * 0.1, rnd(cout), rnd(cout), rnd(cout),
                8 if cout % 8 == 0 else 1)
        conv_inputs[(bsz, h, cin, cout)] = c_args
        for pb, eps in ((None, 1e-5), (rnd(bsz, cin), 1e-5)):
            got = fused_conv1d_gn_mish.kernel(*c_args, pb, eps)
            torch.cuda.synchronize()
            conv_err = max(conv_err, assert_close(f"fused_conv {(bsz, h, cin, cout)} pre_bias="
                                                  f"{pb is not None}", got,
                                                  fused_conv1d_gn_mish.plain(*c_args, pb, eps),
                                                  CONV_TOL))
    c_args = conv_inputs[CONV_SHAPES[-1]]
    pb = torch.randn((c_args[0].shape[0], c_args[0].shape[2]), generator=gen, device=dev)
    got = fused_conv1d_gn_mish.kernel(*c_args, pb, 1e-3)
    torch.cuda.synchronize()
    conv_err = max(conv_err, assert_close("fused_conv eps=1e-3", got,
                                          fused_conv1d_gn_mish.plain(*c_args, pb, 1e-3), CONV_TOL))
    n_conv = 2 * len(CONV_SHAPES) + 1
    if counts(fused_conv1d_gn_mish) != [(n_conv, n_conv)]:
        raise RuntimeError(f"conv: counts {counts(fused_conv1d_gn_mish)}; expected {n_conv} "
                           f"launches and {n_conv} plain calls")
    log("conv", t0, f"fused_conv max |kernel - plain|={conv_err:.3e} at {len(CONV_SHAPES)} shapes "
        f"with and without pre_bias and at eps 1e-3, atol = rtol = {CONV_TOL:.0e}; "
        f"launches={n_conv}, plain calls={n_conv}")

    # 16. the path that runs the conv kernel: the port's bench_kernels --quick
    t0 = time.perf_counter()
    wrappers.append(fused_conv1d_gn_mish)
    reset(*wrappers)
    bench_rows = bench_kernels.main(["--quick"])
    torch.cuda.synchronize()
    conv_launches = fused_conv1d_gn_mish.launches
    conv_rows = [r for r in bench_rows if r["kernel"] == "conv1d_gn_mish"]
    if (counts(*wrappers[:-1]) != [(0, 0)] * (len(wrappers) - 1) or not conv_launches
            or conv_launches != sum(r["launches"] for r in conv_rows)):
        raise RuntimeError(f"bench_kernels: counts {counts(*wrappers)}; expected the conv rows' "
                           f"{sum(r['launches'] for r in conv_rows)} conv launches and nothing "
                           f"of this script's other wrappers")
    for r in bench_rows:
        if r["kernel_us"] is None or r["max_abs_err"] is None or not r["max_abs_err"] <= r["tol"]:
            raise RuntimeError(f"bench_kernels: row {r}")
    log("bench-kernels", t0, f"{len(bench_rows)} rows, every kernel within its tolerance of its "
        f"plain twin: " + "; ".join(
            f"{r['kernel']}{r.get('shape', '')}{' +pre_bias' if r.get('pre_bias') else ''} "
            f"{r['max_abs_err']:.3e} <= {r['tol']:.0e}, {r['kernel_us']:.1f} us "
            f"(plain {r['plain_us']:.1f})" for r in bench_rows) + f"; fused_conv launches="
        f"{conv_launches}")

    # 17. the flagship's control quality with its dataset's statistics
    t0 = time.perf_counter()
    reset(*wrappers)
    par = flagship_parity.run_parity(dev, n_seeds=N_QUALITY, n_steps=N_STEPS)
    if counts(*wrappers) != [(0, 0)] * len(wrappers) or par["chain_launches"] != N_QUALITY * N_STEPS:
        raise RuntimeError(f"flagship quality: {par['chain_launches']} chain launches, counts "
                           f"{counts(*wrappers)}; expected {N_QUALITY * N_STEPS} launches of its "
                           f"own chain and nothing else")
    if not all(math.isfinite(c) for c in par["closed_loop_costs"]):
        raise RuntimeError(f"flagship quality: non-finite costs {par['closed_loop_costs']}")
    if not par["cost_over_expert"] <= FLAGSHIP_MEAN_MAX or par["modality"] != FLAGSHIP_MODALITY:
        raise RuntimeError(f"flagship quality: mean cost over the expert's "
                           f"{par['cost_over_expert']:.6f} (at most {FLAGSHIP_MEAN_MAX}), modality "
                           f"{par['modality']} (expected {FLAGSHIP_MODALITY})")
    reset(*wrappers)
    epq = flagship_parity.run_episode_quality(dev, n_seeds=N_QUALITY, n_steps=N_STEPS)
    if counts(*wrappers) != [(0, 0)] * len(wrappers) or epq["episode_launches"] != N_QUALITY:
        raise RuntimeError(f"flagship quality, episode: {epq['episode_launches']} episode "
                           f"launches, counts {counts(*wrappers)}; expected {N_QUALITY} launches "
                           f"of its own episode and nothing else")
    if not all(math.isfinite(c) for c in epq["closed_loop_costs"]):
        raise RuntimeError(f"flagship quality, episode: non-finite costs {epq['closed_loop_costs']}")
    if not epq["cost_over_expert"] <= FLAGSHIP_MEAN_MAX or epq["modality"] != FLAGSHIP_MODALITY:
        raise RuntimeError(f"flagship quality, episode: mean cost over the expert's "
                           f"{epq['cost_over_expert']:.6f} (at most {FLAGSHIP_MEAN_MAX}), modality "
                           f"{epq['modality']} (expected {FLAGSHIP_MODALITY})")
    log("flagship-quality", t0, f"{N_QUALITY} seeds, K=1, {N_STEPS} replans through cfg_chain "
        f"({par['chain_launches']} launches), the flagship's statistics: closed-loop costs "
        f"{[round(c, 3) for c in par['closed_loop_costs']]}; mean {par['closed_loop_cost_mean']:.3f} "
        f"(report {par['closed_loop_cost_report']}, expert {par['closed_loop_cost_nmpc']}), over "
        f"the expert's {par['cost_over_expert']:.6f} (at most {FLAGSHIP_MEAN_MAX}); modality "
        f"{par['modality']} (report {par['modality_report']}); horizon cost mean "
        f"{par['horizon_cost_mean']:.1f} (report {par['horizon_cost_report']}, expert "
        f"{par['horizon_cost_nmpc']}); seed 0's parity with the expert's tracks "
        f"{ {k: round(v, 5) for k, v in par['parity'].items()} } (report {par['parity_report']}); "
        f"through cfg_episode ({epq['episode_launches']} launches): closed-loop costs "
        f"{[round(c, 3) for c in epq['closed_loop_costs']]}; mean {epq['closed_loop_cost_mean']:.3f}, "
        f"over the expert's {epq['cost_over_expert']:.6f} (at most {FLAGSHIP_MEAN_MAX}); modality "
        f"{epq['modality']}")

    # 18. timing of the conv kernel: the launch alone as the device sees it (100 launches of
    # _launch captured into a CUDA graph, the graph replayed), the whole call, the kernel's device
    # time from torch.profiler, its plain version and the PyTorch calls of the same block
    t0 = time.perf_counter()
    conv_times = []
    for shape in CONV_SHAPES:
        c_args = conv_inputs[shape]
        x_c, w_c, b_c, g_c, be_c, groups = c_args
        xt, wt = x_c.transpose(1, 2).contiguous(), w_c.permute(2, 1, 0).contiguous()
        torch_seq = lambda: F.mish(F.group_norm(F.conv1d(xt, wt, b_c, padding=2), groups, g_c,
                                                be_c, 1e-5))
        seq_err = assert_close(f"torch_seq {shape}", torch_seq().transpose(1, 2),
                               fused_conv1d_gn_mish.plain(*c_args), CONV_TOL)
        bsz, h, cin, cout = shape
        alone = conv_timing.launch_alone(fused_conv1d_gn_mish, c_args)
        row = {"shape": list(shape), "launch_ms": conv_timing.graph_ms(alone),
               "ms": cuda_ms(lambda: fused_conv1d_gn_mish.kernel(*c_args), 200, 10),
               "profiler_ms": conv_timing.profiler_ms(alone),
               "plain_ms": cuda_ms(lambda: fused_conv1d_gn_mish.plain(*c_args), 50, 5),
               "torch_seq_ms": cuda_ms(torch_seq, 200, 10), "torch_seq_max_abs_err": seq_err,
               **bound(2 * bsz * h * 5 * cin * cout,
                       4 * (bsz * h * cin + 5 * cin * cout + 3 * cout + bsz * h * cout))}
        row["bound_share"] = row["bound_ms"] / row["launch_ms"]
        conv_times.append(row)
    log("timing-conv", t0, "; ".join(
        f"{c['shape']}: fused_conv launch alone {c['launch_ms']:.5f} ms, whole call {c['ms']:.5f} "
        f"(profiler " + ("none" if c["profiler_ms"] is None else f"{c['profiler_ms']:.5f}")
        + f"; plain {c['plain_ms']:.4f}, torch_seq {c['torch_seq_ms']:.4f}, bound "
        f"{c['bound_ms']:.6f} by {c['bound_by']}, {100 * c['bound_share']:.2f}% of the launch)"
        for c in conv_times))

    # 19. bf16 weights: the bf16 entries of the CFG chain and CFG episode against their plain
    # bf16 versions, first at one U-Net pass (where a correct kernel agrees but for an occasional
    # flipped rounding), then at full depth (where flips cascade and are only recorded)
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    chain_bf = make_fused_cfg_chain(chain.packed, schedule, n_samples=1, w=W, n_tail=N_TAIL,
                                    weights_dtype=bf16, device=dev)
    sched1 = make_schedule("exponential", 1)  # one step: u_norm = clip(x - 0.01 eps_cfg)
    one = make_fused_cfg_chain(chain.packed, sched1, n_samples=N_ONE_PASS, w=W, n_tail=0,
                               weights_dtype=bf16, device=dev)
    ctx_one = torch.randn((N_ONE_PASS, 5), generator=gen, device=dev)
    noise_one = torch.randn((2, N_ONE_PASS, HORIZON, 1), generator=gen, device=dev)
    got = one.kernel(ctx_one, noise_one)
    torch.cuda.synchronize()
    one_chain = one_pass_gate("cfg_chain_bf16 one pass", got, one.plain(ctx_one, noise_one))
    ep_one = lambda k, n_steps, sel_h=None: make_fused_cfg_episode(
        chain.packed, sched1, inputs_stats, cond_stats, plant, cost, n_steps=n_steps, w=W,
        n_diffusion_steps_without_noise=0, n_candidates=k, selection_horizon=sel_h,
        weights_dtype=bf16, device=dev)
    one_ep, one_chosen = {}, []
    for k, n_steps, sel_h in ((1, N_ONE_PASS, None), (K4, N_STEPS_K4, SEL_H)):
        ep = ep_one(k, n_steps, sel_h)
        nz = torch.randn(ep.noise_shape, generator=gen, device=dev)
        got, want = ep.kernel(x0, nz), ep.plain(x0, nz)
        torch.cuda.synchronize()
        one_ep[k] = one_pass_gate(f"cfg_episode_bf16 K={k} one pass per replan",
                                  got[1][:, :, None] / U_HALF_RANGE, want[1][:, :, None] / U_HALF_RANGE)
        if not torch.equal(got[3], want[3]):
            raise RuntimeError(f"cfg_episode_bf16 K={k} one pass per replan: chosen "
                               f"{got[3].tolist()} vs plain {want[3].tolist()}")
        if k > 1:
            one_chosen = got[3].tolist()
    # full depth: phase 3's contexts, phase 4's noise through 80 replans, K = 4 over 8
    chain_bf_err = 0.0
    for ctx in contexts:
        got = chain_bf.kernel(ctx, noise)
        torch.cuda.synchronize()
        chain_bf_err = max(chain_bf_err, assert_close("cfg_chain_bf16", got,
                                                      chain_bf.plain(ctx, noise), BF16_VS_FP32))
    ep_bf = make_fused_cfg_episode(chain.packed, schedule, inputs_stats, cond_stats, plant, cost,
                                   n_steps=N_STEPS, w=W, n_diffusion_steps_without_noise=N_TAIL,
                                   weights_dtype=bf16, device=dev)
    got_bf = ep_bf.kernel(x0, ep_noise)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want_bf = ep_bf.plain(x0, ep_noise)
    torch.cuda.synchronize()
    plain_bf_episode_s = time.perf_counter() - t1
    du_bf = assert_close("cfg_episode_bf16 80 replans u_norm", got_bf[1] / U_HALF_RANGE,
                         want_bf[1] / U_HALF_RANGE, BF16_VS_FP32)
    dx_bf = (got_bf[0].double() - want_bf[0].double()).abs().max().item()
    du_vs_fp32 = ((got_bf[1] - res.u_track).abs().max() / U_HALF_RANGE).item()
    ep4_bf = make_fused_cfg_episode(chain.packed, schedule, inputs_stats, cond_stats, plant, cost,
                                    n_steps=N_STEPS_K4, w=W, n_diffusion_steps_without_noise=N_TAIL,
                                    n_candidates=K4, selection_horizon=SEL_H, weights_dtype=bf16,
                                    device=dev)
    got4_bf, want4_bf = ep4_bf.kernel(x0, noise4), ep4_bf.plain(x0, noise4)
    torch.cuda.synchronize()
    if not all(torch.isfinite(t).all() for t in (*got_bf[:3], *got4_bf[:3])):
        raise RuntimeError("bf16 episodes: non-finite tracks")
    same4 = int((got4_bf[3] == want4_bf[3]).sum())
    log("bf16", t0, f"one pass (T = 1): cfg_chain_bf16 over {N_ONE_PASS} samples "
        f"{fmt_gate(one_chain)}; cfg_episode_bf16 K=1 over {N_ONE_PASS} replans "
        f"{fmt_gate(one_ep[1])}; K={K4} over {N_STEPS_K4} replans {fmt_gate(one_ep[K4])}, chosen "
        f"{one_chosen} in both. Full depth (T = {T} + {N_TAIL}): cfg_chain_bf16 max |kernel - "
        f"plain| {chain_bf_err:.3e} over {len(contexts)} contexts; cfg_episode_bf16 {N_STEPS} "
        f"replans on phase 4's noise: max |du_norm| {du_bf:.3e}, max |dx| {dx_bf:.3e}, total "
        f"cost kernel {got_bf[2].sum().item():.6f} plain {want_bf[2].sum().item():.6f} (fp32 "
        f"per-replan loop {res.stage_costs.sum().item():.6f}), max "
        f"|du_norm| against the fp32 per-replan loop {du_vs_fp32:.3e}; K={K4} over "
        f"{N_STEPS_K4} replans chosen {got4_bf[3].tolist()} vs plain {want4_bf[3].tolist()} "
        f"({same4} of {N_STEPS_K4} equal); full depth gated at {BF16_VS_FP32:.0e} only (two "
        f"correct bf16 versions part by a flipped rounding that cascades); plain episode "
        f"{plain_bf_episode_s:.3f}s by the host clock")

    # 20. the flagship's quality through the bf16 episode (recorded, not gated: no bf16 report)
    t0 = time.perf_counter()
    reset(*wrappers)
    epq_bf = flagship_parity.run_episode_quality(dev, n_seeds=N_QUALITY, n_steps=N_STEPS,
                                                 weights_dtype=bf16)
    if counts(*wrappers) != [(0, 0)] * len(wrappers) or epq_bf["episode_launches"] != N_QUALITY:
        raise RuntimeError(f"bf16 quality: {epq_bf['episode_launches']} episode launches, counts "
                           f"{counts(*wrappers)}; expected {N_QUALITY} launches of its own "
                           f"episode and nothing else")
    if not all(math.isfinite(c) for c in epq_bf["closed_loop_costs"]):
        raise RuntimeError(f"bf16 quality: non-finite costs {epq_bf['closed_loop_costs']}")
    log("bf16-quality", t0, f"{N_QUALITY} seeds through cfg_episode_bf16 "
        f"({epq_bf['episode_launches']} launches), the flagship's statistics: closed-loop costs "
        f"{[round(c, 3) for c in epq_bf['closed_loop_costs']]}; mean "
        f"{epq_bf['closed_loop_cost_mean']:.3f}, over the expert's "
        f"{epq_bf['cost_over_expert']:.6f} (fp32 {epq['cost_over_expert']:.6f}); modality "
        f"{epq_bf['modality']}")

    # 21. the port's bench: the default mode by its own entry point, in a process of its own,
    # with bench.py's counts; then the other four combinations in this process, cut
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k not in ("BENCH_FUSED", "BENCH_BF16")}
    proc = subprocess.run([sys.executable, "-m", "mpc_via_diffusion_model_tpu_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"bench exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    bench_lines = proc.stdout.strip().splitlines()
    bench_line = json.loads(bench_lines[-1])
    if list(bench_line) != BENCH_EPISODE_KEYS or not bench_line["value"] > 0:
        raise RuntimeError(f"bench: last line {bench_lines[-1]}; expected bench.py's keys "
                           f"{BENCH_EPISODE_KEYS}")
    print(bench_lines[-2], flush=True)
    print(bench_lines[-1], flush=True)
    bench_runs = {}
    for mode, use_bf16, cut in (("episode", True, dict(n_rep=1, n_chain=1, n_best=1)),
                                ("chain", False, dict(n_rep=2)), ("chain", True, dict(n_rep=2)),
                                ("1", False, dict(n_rep=2))):
        r = port_bench.run(mode, use_bf16, dev, **cut)
        if r.launches != port_bench.expected_calls(mode, **cut) or r.plain_calls:
            raise RuntimeError(f"bench {mode} bf16={use_bf16}: {r.launches} launches, "
                               f"{r.plain_calls} plain calls")
        bench_runs[mode, use_bf16] = r
        print(f"bench BENCH_FUSED={mode} BENCH_BF16={int(use_bf16)} {cut}: {r.launches} "
              f"{r.wrapper} launches; " + json.dumps(r.line), flush=True)
    log("bench", t0, f"python3 -m mpc_via_diffusion_model_tpu_torch.bench: {bench_lines[-1]}; "
        f"in process, cut: " + "; ".join(
            f"{m}{' bf16' if b else ''} {r.line['value']} Hz ({r.launches} launches)"
            for (m, b), r in bench_runs.items()))

    # bf16 timing at the main paths' shapes
    chain_bf_ms = cuda_ms(lambda: chain_bf.kernel(contexts[0], noise), n=20, warmup=3)
    chain_bf_plain_ms = cuda_ms(lambda: chain_bf.plain(contexts[0], noise), n=5, warmup=1)
    ep_bf_ms = cuda_ms(lambda: ep_bf.kernel(x0, ep_noise), n=5, warmup=1)
    log("timing-bf16", t0, f"cfg_chain_bf16 {chain_bf_ms:.4f} ms (fp32 {chain_ms:.4f}; plain "
        f"{chain_bf_plain_ms:.4f}) per replan; cfg_episode_bf16 K=1 {ep_bf_ms:.3f} ms per "
        f"{N_STEPS}-replan episode (fp32 {episode_ms:.3f}; plain {1e3 * plain_bf_episode_s:.1f} "
        f"by the host clock)")

    # 22. the LMPC workload's kernels against their plain versions on its committed weights at
    # full width: the CFG chain at horizon 8 and context 4, and the CFG episode's linear cart-pole
    # entry (cfg_episode_lmpc)
    t0 = time.perf_counter()
    lmodel = load_lmpc(LMPC, device=dev)
    l_ins, l_cond = lmpc_stats()
    lx0 = lmpc_parity.sweep_states(1)[0].to(dev)
    lchain = make_fused_cfg_chain(lmodel, schedule, n_samples=1, w=W, n_tail=N_TAIL, device=dev)
    lchain8 = make_fused_cfg_chain(lchain.packed, schedule, n_samples=K8, w=W, n_tail=N_TAIL,
                                   device=dev)
    l_noise = torch.randn((n_total + 1, 1, LMPC_H, 1), generator=gen, device=dev)
    l_contexts = [normalize(l_cond.to(dev), lx0)[None]] + [
        torch.randn((1, 4), generator=gen, device=dev) for _ in range(2)]
    l_ctx8 = torch.randn((K8, 4), generator=gen, device=dev)
    l_noise8 = torch.randn((n_total + 1, K8, LMPC_H, 1), generator=gen, device=dev)
    lchain_err = 0.0
    for ch, c_, nz in [(lchain, c_, l_noise) for c_ in l_contexts] + [(lchain8, l_ctx8, l_noise8)]:
        got = ch.kernel(c_, nz)
        torch.cuda.synchronize()
        lchain_err = max(lchain_err, assert_close(f"cfg_chain H={LMPC_H} B={ch.n_samples}", got,
                                                  ch.plain(c_, nz), CHAIN_TOL))
    lep = lambda k, n_steps: make_fused_cfg_episode(
        lchain.packed, schedule, l_ins, l_cond, cartpole_lmpc(), cartpole_lmpc_cost(),
        n_steps=n_steps, w=W, n_diffusion_steps_without_noise=N_TAIL, n_candidates=k, device=dev)
    lep1, lep8 = lep(1, N_LMPC_EP), lep(K8, N_LMPC_EP8)
    l_ep_noise = torch.randn(lep1.noise_shape, generator=gen, device=dev)
    l_ep_noise8 = torch.randn(lep8.noise_shape, generator=gen, device=dev)
    lep_err, l_chosen, l_ties = 0.0, {}, []
    for ep, nz in ((lep1, l_ep_noise), (lep8, l_ep_noise8)):
        got = ep.kernel(lx0, nz)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = ep.plain(lx0, nz)
        torch.cuda.synchronize()
        if ep is lep1:
            lep_plain_s = time.perf_counter() - t1
        k = ep.n_candidates
        for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
            lep_err = max(lep_err, assert_close(f"cfg_episode_lmpc K={k} {name}", g, w_, TRACK_TOL))
        for i in range(ep.n_steps):
            if k > 1 and near_tie(ep.plain_scores[i]):
                best2 = torch.sort(ep.plain_scores[i].double()).values[:2].tolist()
                l_ties.append(f"replan {i}: best two plain scores {best2[0]:.9g}, {best2[1]:.9g}; "
                              f"kernel chose {int(got[3][i])}, plain {int(want[3][i])}")
            elif got[3][i] != want[3][i]:
                raise RuntimeError(f"cfg_episode_lmpc K={k}: replan {i} chosen {got[3].tolist()} "
                                   f"vs plain {want[3].tolist()}, scores "
                                   f"{ep.plain_scores[i].tolist()}")
        l_chosen[k] = (got[3].tolist(), want[3].tolist())
    if counts(lchain, lchain8, lep1, lep8) != [(3, 3), (1, 1), (1, 1), (1, 1)]:
        raise RuntimeError(f"LMPC kernels vs plain: counts {counts(lchain, lchain8, lep1, lep8)}")
    log("lmpc-kernel-vs-plain", t0, f"cfg_chain at H={LMPC_H}, context 4: max |kernel - plain| "
        f"{lchain_err:.3e} over {len(l_contexts)} contexts at B=1 and one at B={K8} (tol "
        f"{CHAIN_TOL:.0e}); cfg_episode_lmpc from the sweep's first state, K=1 {N_LMPC_EP} "
        f"replans and K={K8} {N_LMPC_EP8}: max |kernel - plain| {lep_err:.3e} (tol "
        f"{TRACK_TOL:.0e}); chosen (kernel, plain) {l_chosen}; near-ties (best two plain scores "
        f"within {NEAR_TIE:.0e}, not gated): {len(l_ties)}: " + " | ".join(l_ties))

    # 23. the LMPC parity workload: scripts/lmpc_parity.py's episode route over the 16 sweep
    # states, 50 replans each, n = 1 gated against the JAX package's loop on the CPU, K = 8
    # reported; the chain route on the first states' noise; the kernels' times
    t0 = time.perf_counter()
    lwrappers = [lchain, lchain8, lep1, lep8]
    reset(*wrappers, *lwrappers)
    lpar = lmpc_parity.run(dev, "episode", candidates=(1,))
    n_states = lpar["n_states"]
    if counts(*wrappers, *lwrappers) != [(0, 0)] * (len(wrappers) + 4) or \
            lpar["launches"][1] != n_states:
        raise RuntimeError(f"LMPC parity: {lpar['launches']} episode launches, counts "
                           f"{counts(*wrappers, *lwrappers)}; expected {n_states} launches of its "
                           f"own episode and nothing else")
    for x_tr, u_tr, _ in lpar["tracks"][1]:
        if not (torch.isfinite(x_tr).all() and torch.isfinite(u_tr).all()):
            raise RuntimeError("LMPC parity: non-finite tracks")
    u_l1 = lpar["per_state_u_l1"][1]
    off = [(i, got, want) for i, (got, want) in enumerate(zip(u_l1, LMPC_U_L1))
           if not abs(got - want) <= LMPC_ABS + LMPC_REL * want]
    jax_mean = LMPC_U_L1_SUMMARY[0]
    if off or not abs(lpar["u_l1_mean"] - jax_mean) <= LMPC_REL * jax_mean:
        raise RuntimeError(f"LMPC parity: states off the JAX package's u_l1 (state, port, JAX): "
                           f"{off}; mean {lpar['u_l1_mean']:.6f} against {jax_mean:.6f}")
    k1_s = time.perf_counter() - t0
    reset(*wrappers, *lwrappers)
    t1 = time.perf_counter()
    lpar8 = lmpc_parity.run(dev, "episode", n_states=N_LMPC_STATES_K8, candidates=(K8,))
    k8_s = time.perf_counter() - t1
    if counts(*wrappers, *lwrappers) != [(0, 0)] * (len(wrappers) + 4) or \
            lpar8["launches"][K8] != N_LMPC_STATES_K8:
        raise RuntimeError(f"LMPC parity K={K8}: {lpar8['launches']} episode launches, counts "
                           f"{counts(*wrappers, *lwrappers)}")
    k8_tracks = lpar8["tracks"][K8]
    if not all(torch.isfinite(x_tr).all() for x_tr, _, _ in k8_tracks):
        raise RuntimeError(f"LMPC parity K={K8}: non-finite tracks")
    not_first = sum(int((chosen != 0).sum()) for _, _, chosen in k8_tracks)
    # the spread of the 8 candidates' first controls, through the chain kernel at B = 8 on the
    # K = 8 run's states and noise of the first states (launches outside the counted runs)
    spread = 0.0
    for i in range(N_LMPC_CHAIN_STATES):
        nz_all = lmpc_parity.state_noise(i, (lmpc_parity.N_STEPS, *lep8.noise_shape[1:]), dev)
        x_tr = k8_tracks[i][0]
        for step in range(lmpc_parity.N_STEPS):
            l_ctx = normalize(l_cond.to(dev), x_tr[step]).expand(K8, 4).contiguous()
            u0 = unnormalize(l_ins.to(dev), lchain8.kernel(l_ctx, nz_all[step]))[:, 0, 0]
            spread = max(spread, (u0.max() - u0.min()).item())
    reset(*wrappers, *lwrappers)
    lpar_chain = lmpc_parity.run(dev, "chain", n_states=N_LMPC_CHAIN_STATES, candidates=(1,))
    n_chain_launches = lpar_chain["launches"][1]
    if n_chain_launches != N_LMPC_CHAIN_STATES * lmpc_parity.N_STEPS or \
            counts(*wrappers, *lwrappers) != [(0, 0)] * (len(wrappers) + 4):
        raise RuntimeError(f"LMPC parity, chain route: {n_chain_launches} chain launches, counts "
                           f"{counts(*wrappers, *lwrappers)}")
    route_err = 0.0
    for i, ((xc, uc, _), (xe, ue, _)) in enumerate(zip(lpar_chain["tracks"][1], lpar["tracks"][1])):
        route_err = max(route_err, assert_close(f"LMPC state {i} chain route x_track", xc, xe,
                                                TRACK_TOL),
                        assert_close(f"LMPC state {i} chain route u_track", uc, ue, TRACK_TOL))
    fmt4 = lambda d: " / ".join(f"{d[k]:.4f}" for k in lmpc_parity.KEYS[:4])
    report = lpar["report"]
    lmpc_line = {
        "n1": {k: lpar[k] for k in lmpc_parity.KEYS}, "n1_per_state_u_l1": u_l1,
        "k8": lpar8[f"candidates{K8}"], "k8_states": N_LMPC_STATES_K8,
        "k8_per_state_u_l1": lpar8["per_state_u_l1"][K8], "k8_choices_not_0": not_first,
        "k8_choices": N_LMPC_STATES_K8 * lmpc_parity.N_STEPS, "k8_first_control_spread": spread,
        "jax_cpu": lpar["jax_cpu"], "report": report, "chain_route_max_abs_err": route_err}
    print(json.dumps({"lmpc_parity": lmpc_line}), flush=True)
    log("lmpc-parity", t0, f"episode route, {n_states} states x {lmpc_parity.N_STEPS} replans, "
        f"n=1 ({lpar['launches'][1]} launches, {k1_s:.3f}s): u_l1 mean/median/best/worst "
        f"{fmt4(lpar)} (JAX on the CPU {fmt4(lpar['jax_cpu'])}; report.json {fmt4(report)}), "
        f"u_step_max_mean {lpar['u_step_max_mean']:.5f}; every state within {LMPC_ABS:.0e} + "
        f"{LMPC_REL:.0%} of the JAX package's, the mean within {LMPC_REL:.0%}. K={K8} over "
        f"{N_LMPC_STATES_K8} states ({lpar8['launches'][K8]} launches, {k8_s:.3f}s, not gated): "
        f"{fmt4(lpar8[f'candidates{K8}'])} (report.json {fmt4(report['candidates8'])}); "
        f"{not_first} of {N_LMPC_STATES_K8 * lmpc_parity.N_STEPS} choices not candidate 0; the "
        f"8 candidates' first controls spread at most {spread:.3e} over the first "
        f"{N_LMPC_CHAIN_STATES} states' replans. Chain route over the first "
        f"{N_LMPC_CHAIN_STATES} states ({n_chain_launches} cfg_chain launches): tracks within "
        f"{route_err:.3e} of the episode's (tol {TRACK_TOL:.0e})")

    # the LMPC kernels' times at the workload's shapes
    lep1_ms = cuda_ms(lambda: lep1.kernel(lx0, l_ep_noise), n=5, warmup=1)
    lep8_ms = cuda_ms(lambda: lep8.kernel(lx0, l_ep_noise8), n=3, warmup=1)
    lchain_ms = cuda_ms(lambda: lchain.kernel(l_contexts[0], l_noise), n=20, warmup=3)
    lchain8_ms = cuda_ms(lambda: lchain8.kernel(l_ctx8, l_noise8), n=20, warmup=3)
    lchain_plain_ms = cuda_ms(lambda: lchain.plain(l_contexts[0], l_noise), n=3, warmup=1)
    log("timing-lmpc", t0, f"cfg_episode_lmpc K=1 {lep1_ms:.3f} ms per {N_LMPC_EP}-replan "
        f"episode = {lep1_ms / N_LMPC_EP:.4f} ms per replan (plain {1e3 * lep_plain_s:.1f} ms by "
        f"the host clock); K={K8} {lep8_ms / N_LMPC_EP8:.4f} ms per replan; cfg_chain at "
        f"H={LMPC_H} {lchain_ms:.4f} ms per replan at B=1, {lchain8_ms:.4f} at B={K8} (plain "
        f"{lchain_plain_ms:.4f})")

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
    # the bf16 entries read every conv kernel (the body's and the final 1x1) as 2 bytes, the rest
    # as 4: the same operations, fewer bytes
    conv_w = sum(math.prod(packed.segments[name][1])
                 for name in [*chain_bf.cluster.split.convs, "final1x1.w"])
    bf16_row = lambda name, source_row, launches, err, ms, plain_ms, flops, n_bytes, **extra: {
        "name": name, "route": "cuda", "source": source_row["source"],
        "replaces": source_row["replaces"], "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, **bound(flops, n_bytes - 2 * conv_w), "library_ms": None,
        "weights_dtype": "bfloat16", "bf16_weight_bytes_saved": 2 * conv_w,
        "registers": cluster_info[name]["registers"],
        "spill_bytes": cluster_info[name]["spill_bytes"],
        "clusters_fit": cluster_info[name]["clusters_fit"], **extra}
    rows = [
        {"name": "cfg_chain", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/cfg_chain.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_denoise.py:47",
         "launches": chain_launches, "max_abs_err": chain_err, "ms": chain_ms,
         "plain_ms": chain_plain_ms, **bound(chain_flops, chain_bytes), "library_ms": None,
         "per_replan_loop_hz": per_replan_hz, "cluster_ctas": CLUSTER, **cluster_info["cfg_chain"]},
        {"name": "fused_unet", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/fused_unet.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_unet.py:387",
         "launches": unet_launches, "max_abs_err": unet_err, "ms": unet_ms,
         "plain_ms": unet_plain_ms, **bound(unet_flops, unet_bytes), "library_ms": None,
         "call_ms": unet_call_ms, "launches_per_replan": unet_launches // N_UNET_LOOP,
         "bench_fused_loop_hz": unet_loop_hz, "cluster_ctas": CLUSTER,
         **cluster_info["fused_unet"]},
        {"name": "cfg_episode", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/cfg_episode.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:410",
         "launches": episode_launches, "max_abs_err": ep_err, "ms": episode_ms,
         "plain_ms": episode_plain_ms, **bound(ep_flops, ep_bytes), "library_ms": None,
         "ms_per_replan": episode_ms / N_STEPS, "k4_ms_per_replan": episode4_ms / N_STEPS_K4,
         "closed_loop_control_hz": control_hz, "cluster_ctas": CLUSTER,
         "flagship_cost_over_expert": epq["cost_over_expert"], **cluster_info["cfg_episode"]},
        {"name": "ddim_chain", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/ddim_chain.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_denoise.py:164",
         "launches": s_chain_launches, "max_abs_err": schain_err, "ms": schain_ms,
         "plain_ms": schain_plain_ms, **bound(schain_flops, schain_bytes), "library_ms": None,
         "times": GRID, "call_ms": schain_call_ms, "grid3_ms": schain3_ms,
         "b4_ms": schain4_ms, "per_replan_loop_hz": s_per_replan_hz, "cluster_ctas": CLUSTER,
         **cluster_info["ddim_chain"]},
        {"name": "ddim_episode", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/ddim_episode.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:142",
         "launches": s_episode_launches, "max_abs_err": sep_err, "ms": sep_ms,
         "plain_ms": sep_plain_ms, **bound(sep_flops, sep_bytes), "library_ms": None,
         "times": GRID, "ms_per_replan": sep_ms / N_STEPS,
         "grid3_ms_per_replan": sep3_ms / N_STEPS, "k4_ms_per_replan": sep4_ms / N_STEPS_K4,
         "student_closed_loop_control_hz": s_control_hz, "cost_ratio_mean": ratio_mean,
         "cost_ratio_max": ratio_max, "cluster_ctas": CLUSTER, **cluster_info["ddim_episode"]},
        # at the bench's largest shape, (64, 8, 64, 128); every shape in "shapes"
        {"name": "fused_conv", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/fused_conv.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_conv.py:126",
         "launches": conv_launches, "max_abs_err": conv_err,
         **{k: conv_times[-1][k] for k in ("ms", "launch_ms", "profiler_ms", "plain_ms",
                                           "bound_ms", "bound_by", "bound_share")},
         "library_ms": None, "torch_seq_ms": conv_times[-1]["torch_seq_ms"],
         "shape": conv_times[-1]["shape"], "shapes": conv_times, **conv_info,
         "flagship_cost_over_expert": par["cost_over_expert"]},
    ]
    rows[0]["bf16"] = bf16_row(
        "cfg_chain_bf16", rows[0], bench_runs["chain", True].launches, one_chain["max"],
        chain_bf_ms, chain_bf_plain_ms, chain_flops, chain_bytes, one_pass=one_chain,
        full_depth_max_abs_err=chain_bf_err, bench_chain_hz=bench_runs["chain", True].line["value"])
    rows[2]["bf16"] = bf16_row(
        "cfg_episode_bf16", rows[2], bench_runs["episode", True].launches, one_ep[1]["max"],
        ep_bf_ms, 1e3 * plain_bf_episode_s, ep_flops, ep_bytes, one_pass=one_ep[1],
        one_pass_k4=one_ep[K4], full_depth_max_abs_err_u_norm=du_bf,
        full_depth_max_abs_err_x=dx_bf, k4_full_depth_chosen_equal=same4,
        bench_episode_hz=bench_runs["episode", True].line["value"],
        flagship_cost_over_expert=epq_bf["cost_over_expert"], flagship_modality=epq_bf["modality"])
    # the LMPC workload: cfg_episode_lmpc, a further entry of kernel 3, at phase 22's 10-replan
    # K = 1 episode; the CFG chain at horizon 8 (under row 1's "h8"), one replan at B = 1
    lpacked = lchain.packed
    l_weights, l_meta = lpacked.weights.numel(), lpacked.meta.numel()
    l_film_w = sum(math.prod(shape) for name, (_, shape) in lpacked.segments.items()
                   if name.split(".")[0] == "films")
    l_film_flops = 2 * 2 * int(lpacked.films_w.shape[1]) * sum(
        rb.cond_mlp[1].out_features for rb in lmodel.res_blocks())
    l_chain_flops = lpacked.flops_per_pass * 2 * n_total
    l_chain_bytes = 4 * (l_weights - l_film_w + l_meta + lchain.films(l_contexts[0]).numel()
                         + l_noise.numel() + lchain.coefs.numel() + LMPC_H)
    l_ep_flops = N_LMPC_EP * n_total * (l_chain_flops / n_total + l_film_flops)
    l_ep_bytes = 4 * (l_weights + l_meta + lep1.t_embs.numel() + l_ep_noise.numel()
                      + lep1.coefs.numel() + lep1.consts.numel() + 4 + (N_LMPC_EP + 1) * 4
                      + N_LMPC_EP * 3)
    rows[0]["h8"] = {
        "name": "cfg_chain", "route": "cuda", "source": rows[0]["source"],
        "replaces": rows[0]["replaces"], "launches": n_chain_launches,
        "max_abs_err": lchain_err, "ms": lchain_ms, "plain_ms": lchain_plain_ms,
        **bound(l_chain_flops, l_chain_bytes), "library_ms": None, "model": "flagship_lmpc",
        "horizon": LMPC_H, "context_dim": 4, "b8_ms": lchain8_ms}
    rows.append({
        "name": "cfg_episode_lmpc", "route": "cuda",
        "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/cfg_episode_lmpc.cu",
        "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:410",
        "entry_of": "cfg_episode", "plant": "cartpole_lmpc",
        "launches": lpar["launches"][1] + lpar8["launches"][K8], "max_abs_err": lep_err,
        "ms": lep1_ms, "plain_ms": 1e3 * lep_plain_s, **bound(l_ep_flops, l_ep_bytes),
        "library_ms": None, "replans": N_LMPC_EP, "ms_per_replan": lep1_ms / N_LMPC_EP,
        "k8_ms_per_replan": lep8_ms / N_LMPC_EP8, "u_l1_mean": lpar["u_l1_mean"],
        "u_l1_mean_jax_cpu": jax_mean, "cluster_ctas": CLUSTER,
        **cluster_info["cfg_episode_lmpc"]})
    rows[2]["bench_closed_loop_control_hz"] = bench_line["value"]
    rows[2]["bench_pipelined_hz"] = bench_line["pipelined_hz"]
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
