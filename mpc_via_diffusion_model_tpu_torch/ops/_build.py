"""Builds the port's CUDA sources with nvcc into shared libraries with a
plain C interface, loaded through ctypes.

No PyTorch header is included and ``torch.utils.cpp_extension`` is not used:
a source with a plain C interface builds in seconds, one that includes
PyTorch's headers in minutes. A library is built at first use into
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``),
under a name that carries a hash of its source, of every header in
``csrc/`` and of the flags, so an edited source or header is rebuilt and an
unchanged one is reused. ``build_all`` builds every library at once, one nvcc
process per source, all started together.
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

__all__ = ["BuildResult", "build", "build_all", "load", "bind", "launch", "BUILD_DIR", "KERNELS",
           "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
NVCC_TIMEOUT_S = 600
KERNELS = ("cfg_chain", "fused_unet", "cfg_episode", "ddim_chain", "ddim_episode")  # csrc/<name>.cu


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
    source, of every ``csrc/*.cuh`` (a source may include any of them) and
    of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
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


def bind(name: str, launch_argtypes, meta_len: int, queries=()) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its C interface
    declared: ``<name>_launch(*launch_argtypes)`` returns a CUDA error code,
    ``<name>_error_string(code)`` its text, and ``<name>_meta_len()`` and
    each ``<name>_<query>()`` of ``queries`` an int. Raises unless the
    library's meta length is ``meta_len``, the packer's."""
    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes, fn.restype = list(launch_argtypes), ctypes.c_int
    fn = getattr(lib, f"{name}_error_string")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    for query in ("meta_len", *queries):
        fn = getattr(lib, f"{name}_{query}")
        fn.argtypes, fn.restype = [], ctypes.c_int
    if getattr(lib, f"{name}_meta_len")() != meta_len:
        raise RuntimeError(f"{name}.cu and ops/unet_pack.py disagree on the meta layout")
    return lib


def launch(lib: ctypes.CDLL, name: str, *args) -> None:
    """Calls ``<name>_launch(*args)``; raises with CUDA's text unless it launched."""
    err = getattr(lib, f"{name}_launch")(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {getattr(lib, f'{name}_error_string')(err).decode()}")
