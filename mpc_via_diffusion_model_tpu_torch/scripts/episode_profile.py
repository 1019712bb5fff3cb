"""Where a replan of the CFG episode kernel spends its time, on the card.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.episode_profile [--replans 8]

No profiler reaches inside one launch, so this script builds a copy of
``csrc/cfg_episode.cu`` whose thread 0 of rank 0 reads ``clock64()`` after
each step of the kernel and adds the cycles since its last reading to that
step's kind: the conv loops of the body, the GroupNorm statistics, the
normalise-and-push passes, the block barriers (with the halo zeroing, skip
copies and concatenations that run just before them), the cluster barriers,
the FiLM vectors, the pass's input, the end of a pass (final 1x1 conv and
the CFG lines) and the end of a replan. The copy lives under
``build/episode_profile/`` and is made by text substitution of the
committed sources, so a change to them that moves a marked line makes this
script raise instead of measuring something else. The counters cost a few
instructions per step; the script also times the unmarked kernel for
comparison. It runs the flagship's K = 1 episode with ``bench.py``'s
synthetic limits, one launch to warm up and one measured, and prints one
JSON line: ms per replan of both builds, and per kind its share and its
microseconds per replan (thread 0's view: a barrier's time is the wait
after its own work), then nvidia-smi's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import make_schedule
from ..data import NormalizerStats
from ..dynamics import cartpole_virtual_cost, cartpole_virtual_swingup, theta_to_red_theta
from ..models import load_flagship
from ..ops import _build
from ..ops.fused_episode import make_fused_cfg_episode
from ..utils.device import resolve_device

ARTIFACTS = Path(__file__).resolve().parents[2] / "artifacts" / "flagship"
KINDS = ("conv", "block_barrier", "gn_stats", "push", "cluster_barrier", "film", "pass_input",
         "pass_end", "replan_end")
_PROF = '''#include "unet_body.cuh"
__device__ long long g_prof[16];
__device__ long long g_last;
#define PROF(k) do { if (threadIdx.x == 0 && blockIdx.x == 0) { \\
  long long t_ = clock64(); g_prof[k] += t_ - g_last; g_last = t_; } } while (0)
'''


def _sub(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"episode_profile: expected {count} of {old!r} in the kernel sources")
    return text.replace(old, new)


def instrument(csrc: Path, out: Path) -> None:
    """Copies ``csrc`` to ``out`` with the clock64 marks in the cluster
    body and the episode kernel."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    k = KINDS.index
    h = (out / "unet_body_cluster.cuh").read_text()
    h = _sub(h, '#include "unet_body.cuh"\n', _PROF)
    wrapped = {"cconv": ("template <int NB, bool PUSH, typename... A>", "cconv_impl<NB, PUSH>(a...)",
                         k("conv")),
               "cupsample_push": ("template <int NB, typename... A>", "cupsample_push_impl<NB>(a...)",
                                  k("conv")),
               "cgroup_stats": ("template <int NB, typename... A>", "cgroup_stats_impl<NB>(a...)",
                                k("gn_stats")),
               "cgn_mish_push": ("template <int NB, typename... A>", "cgn_mish_push_impl<NB>(a...)",
                                 k("push"))}
    for fn, (tmpl, call, kind) in wrapped.items():
        h = _sub(h, f"static __device__ void {fn}(", f"static __device__ void {fn}_impl(")
        h = _sub(h, "// ResidualTemporalBlock on the cluster",
                 f"{tmpl}\nstatic __device__ void {fn}(A... a) {{ {call}; PROF({kind}); }}\n"
                 "// ResidualTemporalBlock on the cluster")
    n_sync = h.count("  __syncthreads();")
    h = _sub(h, "  __syncthreads();", f"  __syncthreads(); PROF({k('block_barrier')});", n_sync)
    n_csync = h.count("cg::this_cluster().sync();")
    h = _sub(h, "cg::this_cluster().sync();",
             f"cg::this_cluster().sync(); PROF({k('cluster_barrier')});", n_csync)
    (out / "unet_body_cluster.cuh").write_text(h)
    e = (out / "cfg_episode.cu").read_text()
    e = _sub(e, "  const int rank = (int)cg::this_cluster().block_rank();\n",
             "  const int rank = (int)cg::this_cluster().block_rank();\n"
             "  if (threadIdx.x == 0 && blockIdx.x == 0) g_last = clock64();\n")
    e = _sub(e, "films, rank, CLUSTER);\n", f"films, rank, CLUSTER);\n      PROF({k('film')});\n")
    e = _sub(e, "          const float* y = cunet_body<NB, WT>(",
             f"          PROF({k('pass_input')});\n          const float* y = cunet_body<NB, WT>(")
    e = _sub(e, "          xs[i] = __fadd_rn(mean, __fmul_rn(sg, z));\n        }\n"
                "        __syncthreads();\n",
             "          xs[i] = __fadd_rn(mean, __fmul_rn(sg, z));\n        }\n"
             f"        __syncthreads();\n        PROF({k('pass_end')});\n")
    e = _sub(e, "costs, chosen, rank == 0);\n",
             f"costs, chosen, rank == 0);\n    PROF({k('replan_end')});\n")
    e = _sub(e, "int cfg_episode_cluster_size(void)",
             "int cfg_episode_profile_read(long long* out) {\n"
             "  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
             "  if (e != cudaSuccess) return (int)e;\n"
             "  long long zero[16] = {0};\n"
             "  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));\n}\n\n"
             "int cfg_episode_cluster_size(void)")
    (out / "cfg_episode.cu").write_text(e)


def build_copy(src: Path) -> Tuple[ctypes.CDLL, str]:
    """nvcc on the edited copy ``src/cfg_episode.cu`` with the port's flags,
    into ``src/libcfg_episode.so``; returns the library, its C interface
    declared as ``FusedCfgEpisode._launch`` calls it, and nvcc's report."""
    lib_path = src / "libcfg_episode.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                           str(src / "cfg_episode.cu")], capture_output=True, text=True,
                          timeout=_build.NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src / 'cfg_episode.cu'}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    pv, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cfg_episode_launch.argtypes = [pv, pv, i, pv, pv, pv, pv, pv, pv, pv, pv, pv, i, i, i, i, f, f, i,
                                      pv]
    lib.cfg_episode_launch.restype = i
    lib.cfg_episode_error_string.argtypes, lib.cfg_episode_error_string.restype = [i], ctypes.c_char_p
    for query in ("plant_dims", "consts_len"):
        getattr(lib, f"cfg_episode_{query}").restype = i
    return lib, (proc.stdout + proc.stderr).strip()


def launch_copy(ep, lib: ctypes.CDLL, x0: torch.Tensor, noise_tab: torch.Tensor):
    """One launch of ``ep``'s CFG episode (a ``FusedCfgEpisode``) on the
    built copy ``lib`` in place of the port's library, through the wrapper's
    own launch path (its checks, occupancy query and outputs); ``noise_tab``
    is the noise in the kernel's order. Returns what ``ep.kernel`` returns."""
    return ep._launch(x0, noise_tab, ep.w, float(np.float32(1.0 + ep.w)), lib=lib)


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--replans", type=int, default=8)
    args = p.parse_args(argv)
    dev = resolve_device(None)  # raises without a card
    src = _build.BUILD_DIR.parent / "episode_profile"
    instrument(_build.CSRC, src)
    prof, _ = build_copy(src)
    ins = NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0))
    cs = NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0))
    ep = make_fused_cfg_episode(load_flagship(ARTIFACTS / "ema_params.pkl", device=dev),
                                make_schedule("exponential", 25), ins, cs,
                                cartpole_virtual_swingup(), cartpole_virtual_cost(),
                                n_steps=args.replans, w=0.01, n_diffusion_steps_without_noise=5,
                                device=dev)
    x0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    noise = torch.randn(ep.noise_shape, generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    noise_tab = torch.cat([noise[:, 1:], noise[:, :1]], dim=1).contiguous()
    counts = (ctypes.c_longlong * 16)()

    def timed(fn) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()  # warm-up
        torch.cuda.synchronize()
        prof.cfg_episode_profile_read(counts)  # and zero the counters
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.replans

    plain_ms = timed(lambda: ep.kernel(x0, noise))
    marked_ms = timed(lambda: launch_copy(ep, prof, x0, noise_tab))
    err = prof.cfg_episode_profile_read(counts)
    if err:
        raise RuntimeError(f"reading the counters failed: {prof.cfg_episode_error_string(err).decode()}")
    cycles = [int(counts[j]) for j in range(len(KINDS))]
    total = sum(cycles)
    out = {"replans": args.replans, "ms_per_replan": plain_ms, "marked_ms_per_replan": marked_ms,
           "cycles_per_replan": total / args.replans,
           "clock_ghz": total / args.replans / marked_ms / 1e6,
           "kinds": {kind: {"share": c / total, "us_per_replan": c / total * marked_ms * 1e3}
                     for kind, c in zip(KINDS, cycles)}}
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return out


if __name__ == "__main__":
    main()
