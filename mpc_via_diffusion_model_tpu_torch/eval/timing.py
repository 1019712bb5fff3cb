"""Timing harness: host-clock measurement of PyTorch calls.

Port of ``mpc_via_diffusion_model_tpu/eval/timing.py``. PyTorch returns from
a CUDA call before the card has finished it, so every measured region ends in
``torch.cuda.synchronize()`` where the JAX file calls ``block_until_ready``;
on the CPU the call has finished when it returns.
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["time_fn", "pipelined_time_fn", "Timer"]


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, n_warmup: int = 1, n_repeat: int = 5) -> Dict[str, float]:
    """Time ``fn(*args)``: wall-clock stats in seconds, median/mean/min over
    ``n_repeat`` calls after ``n_warmup``, each call synchronised."""
    for _ in range(n_warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(n_repeat):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {"median_s": float(np.median(arr)), "mean_s": float(arr.mean()),
            "min_s": float(arr.min()), "n": n_repeat}


def pipelined_time_fn(fn, args_list, n_batches: int = 3) -> float:
    """Best-of-batches pipelined timing: one warmup call, then ``n_batches``
    times the whole ``args_list`` issued back to back with ONE synchronise
    after it, divided by its length; returns the best batch's seconds per
    call. The host's launch work for a call overlaps the card's run of the
    calls before it, as in a loop that does not wait."""
    fn(*args_list[0])
    _sync()
    dts = []
    for _ in range(n_batches):
        t0 = time.perf_counter()
        for a in args_list:
            fn(*a)
        _sync()
        dts.append((time.perf_counter() - t0) / len(args_list))
    return min(dts)


class Timer:
    """Context-manager wall timer (host side); synchronises nothing."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False
