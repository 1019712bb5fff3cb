"""Builds the port's CUDA sources with nvcc into shared libraries with a
plain C interface, loaded through ctypes.

No PyTorch header is included and ``torch.utils.cpp_extension`` is not used:
a source with a plain C interface builds in seconds, one that includes
PyTorch's headers in minutes. A library is built at first use into
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``),
under a name that carries a hash of its source, of every header in
``csrc/``, of the sources it includes and of the flags, so an edited source
or header is rebuilt and an unchanged one is reused. ``build_all`` builds every library at once, one nvcc
process per source, all started together. ``ClusterLaunch`` is what the
wrappers of the kernels launched as thread-block clusters share.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from .unet_pack import (CLUSTER, SMEM_LIMIT, ClusterSplit, PackedUnet, cluster_split,
                        cluster_weights)

__all__ = ["BuildResult", "build", "build_all", "load", "bind", "launch", "max_active_clusters",
           "ClusterLaunch", "BUILD_DIR", "KERNELS", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
NVCC_TIMEOUT_S = 600
KERNELS = ("cfg_chain", "fused_unet", "cfg_episode", "ddim_chain", "ddim_episode",
           "fused_conv", "cfg_episode_lmpc", "ddim_episode_quadrotor",
           "cfg_episode_quadrotor", "ddim_episode_panda", "cfg_episode_panda",
           "cfg_chain_turns")  # csrc/<name>.cu


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float   # nvcc wall time; 0.0 when an existing build was reused
    report: str      # nvcc's output: the -Xptxas -v register and shared-memory report


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _target(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source, of every ``csrc/*.cuh`` (a source may include any of them), of
    every other source it includes (``cfg_episode_lmpc.cu`` includes
    ``cfg_episode.cu``) and of the flags."""
    source = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(source)
    included = re.findall(rb'^#include "(\w+\.cu)"', source, flags=re.M)
    for header in sorted(CSRC.glob("*.cuh")) + [CSRC / f.decode() for f in included]:
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, out: Path, proc, tmp: Path, t0: float) -> BuildResult:
    try:
        report, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc on {name}.cu took over {NVCC_TIMEOUT_S} s")
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n{report}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, report.strip())


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` for sm_90a unless this exact source,
    header set and flag set was built before."""
    return build_all((name,))[name]


def build_all(names=KERNELS) -> dict:
    """Build the named libraries (all of them by default), one nvcc process
    per source, all started together; returns name -> BuildResult."""
    results, running = {}, {}
    for name in names:
        out = _target(name)
        if out.exists():
            results[name] = BuildResult(out, 0.0, "")
        else:
            running[name] = (out, *_start(name, out), time.perf_counter())
    try:
        for name, (out, proc, tmp, t0) in running.items():
            results[name] = _finish(name, out, proc, tmp, t0)
    finally:  # stop any nvcc still running when one failed
        for _, proc, tmp, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
                tmp.unlink(missing_ok=True)
    return {name: results[name] for name in names}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build(name).path))


def bind(name: str, launch_argtypes, meta_len: int, queries=(), cluster: int = 0,
         source: Optional[str] = None) -> ctypes.CDLL:
    """The built library of ``csrc/<source>.cu`` (``source`` defaults to
    ``name``) with the C interface of its entry ``name`` declared:
    ``<name>_launch(*launch_argtypes)`` returns a CUDA error code,
    ``<name>_error_string(code)`` its text, and ``<name>_meta_len()`` and
    each ``<name>_<query>()`` of ``queries`` an int. Raises unless the
    library's meta length is ``meta_len``, the packer's. A kernel launched
    as thread-block clusters of ``cluster`` CTAs (when not 0) also declares
    ``<name>_max_active_clusters(smem_bytes, int*)`` and
    ``<name>_cluster_size()``, which must answer ``cluster``. A library
    with two instantiations of its kernel (the float and bf16 weights of
    ``cfg_chain.cu``, ``cfg_episode.cu``, ``fused_unet.cu``,
    ``ddim_chain.cu``, ``ddim_episode.cu`` and ``ddim_episode_panda.cu``) exports each as an entry
    of its own, ``<source>`` and ``<source>_bf16``, each with its
    occupancy query."""
    if cluster:
        queries = (*queries, "cluster_size")
    lib = load(source or name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes, fn.restype = list(launch_argtypes), ctypes.c_int
    fn = getattr(lib, f"{name}_error_string")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    for query in ("meta_len", *queries):
        fn = getattr(lib, f"{name}_{query}")
        fn.argtypes, fn.restype = [], ctypes.c_int
    if getattr(lib, f"{name}_meta_len")() != meta_len:
        raise RuntimeError(f"{name}.cu and ops/unet_pack.py disagree on the meta layout")
    if cluster:
        fn = getattr(lib, f"{name}_max_active_clusters")
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
        if getattr(lib, f"{name}_cluster_size")() != cluster:
            raise RuntimeError(f"{name}.cu and ops/unet_pack.py disagree on the cluster size")
    return lib


def max_active_clusters(lib: ctypes.CDLL, name: str, smem_bytes: int) -> int:
    """How many clusters of ``<name>``'s kernel fit on the current CUDA
    device at once with ``smem_bytes`` of dynamic shared memory per CTA
    (``cudaOccupancyMaxActiveClusters``, through
    ``<name>_max_active_clusters``); raises with CUDA's text when the query
    fails."""
    n = ctypes.c_int(0)
    err = getattr(lib, f"{name}_max_active_clusters")(int(smem_bytes), ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed for the {name} kernel: "
                           f"{getattr(lib, f'{name}_error_string')(err).decode()}")
    return n.value


def launch(lib: ctypes.CDLL, name: str, *args) -> None:
    """Calls ``<name>_launch(*args)``; raises with CUDA's text unless it launched."""
    err = getattr(lib, f"{name}_launch")(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {getattr(lib, f'{name}_error_string')(err).decode()}")


class ClusterLaunch:
    """What the wrappers of the five cluster kernels (``cfg_chain``,
    ``fused_unet``, ``cfg_episode``, ``ddim_chain``, ``ddim_episode``)
    share: the body's split and the rank-major buffer the kernel reads
    (and its bf16 copy, which every ``_bf16`` entry reads beside it), made
    when first asked for, so
    that a body the cluster cannot split raises ``ValueError`` where the
    kernel would be launched and not on the CPU path; and the kernel's
    occupancy query (``query(smem_bytes)``, its wrapper module's
    ``<name>_max_active_clusters``), asked once before the first launch,
    which refuses with ``RuntimeError`` when no cluster fits on the card.
    Nothing falls back to the plain version or to another entry."""

    def __init__(self, packed: PackedUnet, name: str, query: Callable[[int], int]):
        self.packed, self.name, self._query = packed, name, query
        self._split: Optional[ClusterSplit] = None
        self._weights: Optional[torch.Tensor] = None
        self._weights_bf16: Optional[torch.Tensor] = None
        self.slots: Optional[int] = None  # clusters that fit at once, asked before the first launch

    @property
    def split(self) -> ClusterSplit:
        if self._split is None:
            self._split = cluster_split(self.packed)
        return self._split

    @property
    def weights(self) -> torch.Tensor:
        """The packed buffer with the body's conv kernels rank-major (``cluster_weights``)."""
        if self._weights is None:
            self._weights = cluster_weights(self.packed, self.split)
        return self._weights

    @property
    def weights_bf16(self) -> torch.Tensor:
        """``weights`` rounded to bf16 (to nearest even) at the same element
        offsets: the bf16 entries read their conv kernels from it and every
        other segment from ``weights``."""
        if self._weights_bf16 is None:
            self._weights_bf16 = self.weights.to(torch.bfloat16)
        return self._weights_bf16

    def require_fit(self, smem_bytes: int, device) -> None:
        """Raises ``ValueError`` when the kernel's plan, ``smem_bytes`` of
        shared memory per CTA, is more than a block may take (SMEM_LIMIT),
        and ``RuntimeError`` unless a cluster of CLUSTER CTAs with that
        much each fits on ``device``; asks CUDA the first time only."""
        if smem_bytes > SMEM_LIMIT:
            raise ValueError(f"the {self.name} kernel's plan needs {smem_bytes} B of shared memory "
                             f"per CTA, over the {SMEM_LIMIT} B a block may take")
        if self.slots is None:
            slots = self._query(smem_bytes)
            if not slots:
                raise RuntimeError(
                    f"no cluster of {CLUSTER} CTAs with {smem_bytes} B of shared memory each fits "
                    f"on {torch.cuda.get_device_name(device)}: the {self.name} kernel needs "
                    "thread-block clusters (sm_90)")
            self.slots = slots
