"""The episode kernel's in-kernel noise in plain PyTorch: Philox4x32-10
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011) and
the JAX package's Box-Muller map ``_bits_to_normal``
(``mpc_via_diffusion_model_tpu/ops/fused_episode.py:65``), the plain twin of
``csrc/philox.cuh``.

The JAX episode draws its in-kernel noise from the TPU's per-core hardware
generator, seeded by the two words of its key (``_key_to_seeds``); the CUDA
kernel draws from a counter-based generator instead, so that every CTA of
its cluster computes the same values with no exchange: the normal at
(replan s, candidate k, row t, channel d) of an episode seeded (k0, k1) is
``bits_to_normal(w0, w1)`` of the words ``(w0, w1, w2, w3) =
philox4x32_10((s, k, t, d), (k0, k1))``. ``normal_table`` expands a seed
into the staged table (n_steps, K, H, D) that the draw produces, so the
kernel with in-kernel noise is held to the plain episode on that table.

The CFG episode draws n_total + 1 normals per replan, candidate, row and
channel: x_T and one injected at each step. Its counter's first word is the
JAX kernel's draw index ``step * (n_total + 1) + j`` (fused_episode.py:554,
:599, :602), j = n_total for x_T: the normal at (replan s, draw j,
candidate k, row t, channel d) comes from ``philox4x32_10((s (n_total + 1)
+ j, k, t, d), (k0, k1))``, which at n_total + 1 = 1 is the DDIM draw's
counter. ``cfg_normal_table`` stages it as the CFG episode takes noise.

uint32 words are held in int64 tensors and masked; a 32 x 32-bit product is
taken in 16-bit halves so that no intermediate passes 2^49.

``words`` and ``table`` are the wrappers of the draw's test entries in the
quadrotor episode's library (``csrc/ddim_episode_quadrotor.cu``,
``ddim_episode_quadrotor_philox_{words,normals}``): on CUDA tensors they
launch the kernel, which runs the episode's own ``philox.cuh``, and count the
launch in ``LAUNCHES``; on CPU tensors they run the twin above.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["philox4x32_10", "bits_to_normal", "normal_table", "cfg_normal_table",
           "seed_from_generator",
           "seed_words", "words", "table", "LAUNCHES"]

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57  # the round multipliers
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85  # the key schedule's increments
ROUNDS = 10
INV24 = np.float32(1.0 / 16777216.0)
TWO_PI = np.float32(2.0 * np.pi)


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the words ``b``."""
    t1 = a * (b & 0xFFFF)                     # < 2^48
    t2 = a * (b >> 16)                        # < 2^48
    s = t1 + ((t2 & 0xFFFF) << 16)            # < 2^49
    return ((t2 >> 16) + (s >> 32)) & MASK32, s & MASK32


def philox4x32_10(counter: Sequence[torch.Tensor], key: Sequence[torch.Tensor]):
    """The four output words of Philox4x32 with 10 rounds for the counter
    words (c0, c1, c2, c3) and key words (k0, k1): int64 tensors (or ints)
    of uint32 values that broadcast together. Returns a tuple of four int64
    tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) & MASK32 for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) & MASK32 for k in key)
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_normal(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Box-Muller N(0, 1) from two uint32 words (int64 tensors), as the JAX
    package's ``_bits_to_normal``: the top 24 bits of each word,
    u1 = (i1 + 1) / 2^24 in (0, 1], u2 = i2 / 2^24 in [0, 1),
    sqrt(-2 log u1) cos(2 pi u2), in float32."""
    i1 = (b1 >> 8).to(torch.float32)
    i2 = (b2 >> 8).to(torch.float32)
    u1 = (i1 + 1.0) * float(INV24)
    u2 = i2 * float(INV24)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(float(TWO_PI) * u2)


def seed_words(seed: torch.Tensor) -> Tuple[int, int]:
    """The two key words (uint32 values) of a (2,) int32 seed."""
    s = [int(v) & MASK32 for v in seed.reshape(-1).tolist()]
    if len(s) != 2:
        raise ValueError(f"a seed is 2 words, got {len(s)}")
    return s[0], s[1]


def normal_table(seed: torch.Tensor, shape: Tuple[int, int, int, int], device=None) -> torch.Tensor:
    """The in-kernel draw of a whole episode as a staged table: (n_steps, K,
    H, D) float32, entry (s, k, t, d) the normal of counter (s, k, t, d)
    under the key of ``seed`` ((2,) int32, as ``_key_to_seeds`` gives), on
    ``device`` (the seed's by default)."""
    n_steps, k, h, d = shape
    return cfg_normal_table(seed, n_steps, 0, k, h, d, device)[:, 0]


def cfg_normal_table(seed: torch.Tensor, n_steps: int, n_total: int, n_candidates: int,
                     horizon: int, dim: int, device=None) -> torch.Tensor:
    """The CFG episode's in-kernel draw of a whole episode, staged as the
    episode takes noise: (n_steps, n_total + 1, K, H, D) float32, with
    ``[:, 0]`` the x_T draw (j = n_total) and ``[:, 1 + j]`` the draw
    injected at step j; entry (s, i, k, t, d) the normal of counter
    (s (n_total + 1) + j, k, t, d), j = (i - 1) mod (n_total + 1), under the
    key of ``seed``, on ``device`` (the seed's by default)."""
    k0, k1 = seed_words(seed)
    dev = seed.device if device is None else torch.device(device)
    idx = [torch.arange(n, dtype=torch.int64, device=dev)
           for n in (n_steps, n_total + 1, n_candidates, horizon, dim)]
    s, i, k, t, d = torch.meshgrid(*idx, indexing="ij")
    j = (i + n_total) % (n_total + 1)
    w0, w1, _, _ = philox4x32_10((s * (n_total + 1) + j, k, t, d), (k0, k1))
    return bits_to_normal(w0, w1)


def seed_from_generator(generator: torch.Generator = None) -> torch.Tensor:
    """A (2,) int32 seed, both words drawn from ``generator``."""
    v = torch.randint(0, 2 ** 32, (2,), generator=generator, dtype=torch.int64)
    return (v - (v >= 2 ** 31).to(torch.int64) * 2 ** 32).to(torch.int32)


LAUNCHES = {"words": 0, "normals": 0}  # kernel launches of the test entries; callers reset them
_LIB = "ddim_episode_quadrotor"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built quadrotor episode library with its two test entries declared."""
    lib = _build.load(_LIB)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("philox_words", [p, p, p, i, p]),
                       ("philox_normals", [p, p, i, i, i, i, p])):
        fn = getattr(lib, f"{_LIB}_{name}_launch")
        fn.argtypes, fn.restype = args, ctypes.c_int
    getattr(lib, f"{_LIB}_error_string").restype = ctypes.c_char_p
    return lib


def _launch(name: str, *args) -> None:
    lib = _lib()
    err = getattr(lib, f"{_LIB}_{name}_launch")(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {getattr(lib, f'{_LIB}_error_string')(err).decode()}")
    LAUNCHES[name.split("_")[1]] += 1


def words(counters: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of n (counter, key) pairs: counters (n, 4) and keys (n,
    2) int64 of uint32 values -> (n, 4) int64 words; by the kernel on a CUDA
    tensor, by ``philox4x32_10`` on a CPU one."""
    if counters.shape[-1] != 4 or keys.shape[-1] != 2 or counters.shape[0] != keys.shape[0]:
        raise ValueError(f"counters (n, 4) and keys (n, 2), got {tuple(counters.shape)} and "
                         f"{tuple(keys.shape)}")
    if counters.device.type == "cpu":
        return torch.stack(philox4x32_10(counters.unbind(-1), keys.unbind(-1)), dim=-1)
    c, k = ((t & MASK32).to(torch.int32).contiguous() for t in (counters, keys))  # the bits
    out = torch.empty_like(c)
    _launch("philox_words", c.data_ptr(), k.data_ptr(), out.data_ptr(), c.shape[0],
            torch.cuda.current_stream(c.device).cuda_stream)
    return out.to(torch.int64) & MASK32


def table(seed: torch.Tensor, shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """``normal_table(seed, shape)``: by the kernel the episode draws with on
    a CUDA seed, by the twin on a CPU one."""
    if seed.device.type == "cpu":
        return normal_table(seed, shape)
    if tuple(seed.shape) != (2,) or seed.dtype != torch.int32:
        raise ValueError(f"the seed must be (2,) int32, got {tuple(seed.shape)} {seed.dtype}")
    out = torch.empty(tuple(shape), dtype=torch.float32, device=seed.device)
    _launch("philox_normals", seed.contiguous().data_ptr(), out.data_ptr(), *shape,
            torch.cuda.current_stream(seed.device).cuda_stream)
    return out
