"""Builds the port's CUDA sources with nvcc into shared libraries with a
plain C interface, loaded through ctypes.

No PyTorch header is included and ``torch.utils.cpp_extension`` is not used:
a source with a plain C interface builds in seconds, one that includes
PyTorch's headers in minutes. A library is built at first use into
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``),
under a name that carries a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BuildResult", "build", "load", "BUILD_DIR", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
NVCC_TIMEOUT_S = 600


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


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` for sm_90a unless this exact source and
    flag set was built before."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, (proc.stdout + proc.stderr).strip())


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build(name).path))
