"""Fused Conv1d(k5, 'same') + optional FiLM pre-bias + GroupNorm + Mish as one
CUDA kernel, beside its plain PyTorch version.

Port of ``mpc_via_diffusion_model_tpu/ops/fused_conv.py``, with its signature
and the flax weight layout: x (B, H, Cin), w (5, Cin, Cout), b, gamma and beta
(Cout,), pre_bias (B, Cin) or None -> (B, H, Cout).
``fused_conv1d_gn_mish`` launches ``csrc/fused_conv.cu`` when the tensors lie
on a CUDA device and runs ``conv1d_gn_mish_reference`` when they lie on the
CPU. On a CUDA tensor it launches the kernel or raises: it never falls back
to the plain version there.

The kernel runs one CTA of 8 warps per (GroupNorm group, chunk of batch
elements) and the conv on the tensor cores (``mma.sync`` m16n8k8, tf32
operands split 3xTF32 so that the sums keep fp32 accuracy); ``conv_plan`` is
its cut of a call, which the launcher computes again and checks. ``kernel``
checks and allocates, ``_launch`` launches on prepared tensors and is the one
place a launch is counted (``scripts/conv_timing.py`` captures it into a
CUDA graph to time the launch alone).

As in the JAX package, the block is on no model path: the U-Net kernels run
the same conv and GroupNorm inside their body (``csrc/unet_body_cluster.cuh``),
and ``scripts/bench_kernels.py`` times this one against its plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ..models.layers import mish
from . import _build
from .unet_pack import HALO, M_LEN, SMEM_LIMIT

__all__ = ["FusedConv1dGnMish", "fused_conv1d_gn_mish", "conv1d_gn_mish_reference",
           "ConvPlan", "conv_plan"]

KERNEL_SIZE = 5


@torch.no_grad()
def conv1d_gn_mish_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                             gamma: torch.Tensor, beta: torch.Tensor, n_groups: int,
                             pre_bias: Optional[torch.Tensor] = None,
                             eps: float = 1e-5) -> torch.Tensor:
    """The plain version, op for op as mpc_via_diffusion_model_tpu/ops/fused_conv.py:37-68:
    the pre-bias, five shifted products with zero fill, the group mean and
    the two-pass group variance, then Mish."""
    if pre_bias is not None:
        x = x + pre_bias[:, None, :]
    bsz, h, _ = x.shape
    cout = w.shape[-1]
    y = torch.zeros((bsz, h, cout), dtype=x.dtype, device=x.device) + b
    for k in range(KERNEL_SIZE):
        shift = k - 2
        xs = torch.roll(x, -shift, dims=1)
        if shift < 0:
            xs[:, :-shift, :] = 0.0
        elif shift > 0:
            xs[:, -shift:, :] = 0.0
        y = y + torch.einsum("bhc,cd->bhd", xs, w[k])
    yg = y.reshape(bsz, h, n_groups, cout // n_groups)
    mean = yg.mean(dim=(1, 3), keepdim=True)
    var = ((yg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    yn = ((yg - mean) / torch.sqrt(var + eps)).reshape(bsz, h, cout)
    return mish(yn * gamma + beta)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How ``csrc/fused_conv.cu`` cuts one call: one CTA of ``WARPS`` warps
    per (GroupNorm group, chunk of ``chunk`` batch elements), on ``grid`` =
    (groups, ceil(B / chunk)). The CTA's conv is a (chunk * H) x cpg x
    5 * Cin product on ``mma.sync`` m16n8k8 tiles: ``m_tiles`` x ``n_tiles``
    output tiles, ``k_steps`` = k_pad / 8 steps of depth 8. The warps form
    ``tile_groups`` groups of ``k_splits`` warps: group r owns the tiles r,
    r + tile_groups, ... (``tiles_per_warp`` at most), and split s of it
    the k-steps s, s + k_splits, ...

    Shared memory, in floats: the weight slice as k_pad rows of ``w_stride``
    floats at 0; the chunk's inputs as rows of ``x_stride`` floats, HALO
    zero rows above and below each element; a table of k_pad ints, the
    offset of each K column (tap k, channel ci) from its row's start,
    k * x_stride + ci, or -1 in the K padding. The strides are padded so
    that a warp's fragment loads hit 32 different banks: x_stride = 4
    (mod 8), w_stride = 8 (mod 16). After the product the split-K partials
    ((k_splits - 1) * tiles * 128 floats) overwrite them. Then the
    epilogue's floats: the group's bias, gamma and beta (cpg each), staged
    with the weights, and the two passes' sums (one per warp and element
    each)."""
    chunk: int
    grid: Tuple[int, int]
    cpg: int              # channels of a group, Cout / groups
    cpg_pad: int          # cpg padded to a multiple of 8, the n8 tiles' width
    k_pad: int            # 5 * Cin padded to a multiple of 8
    w_stride: int         # floats per weight row, cpg_pad or cpg_pad + 8
    x_stride: int         # floats per input row, Cin padded to 4 (mod 8)
    m_tiles: int
    n_tiles: int
    tile_groups: int
    k_splits: int
    tiles_per_warp: int
    operand_floats: int   # the weight slice, the inputs and the column table
    partial_floats: int   # the split-K partials, over the operands
    epilogue_floats: int  # bias, gamma, beta; the sums of the statistics' two passes
    smem_bytes: int

    @property
    def k_steps(self) -> int:
        return self.k_pad // 8

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles


WARPS = 8                 # warps per CTA
MAX_TILES_PER_WARP = 4    # m16n8 tiles a warp holds in registers (three accumulators each)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def conv_plan(bsz: int, h: int, cin: int, cout: int, n_groups: int) -> ConvPlan:
    """The kernel's cut of a call (``ConvPlan``); the launcher in
    ``csrc/fused_conv.cu`` computes the same and refuses a launch whose
    shared memory differs. ``chunk`` = max(1, 16 // H), at most B, so that
    one m16 tile holds whole batch elements at H = 8."""
    cpg = cout // n_groups
    chunk = min(bsz, max(1, 16 // h))
    cpg_pad, k_pad = 8 * _ceil(cpg, 8), 8 * _ceil(KERNEL_SIZE * cin, 8)
    w_stride = cpg_pad + (8 if cpg_pad % 16 == 0 else 0)
    x_stride = cin + (4 - cin) % 8
    m_tiles, n_tiles = _ceil(chunk * h, 16), cpg_pad // 8
    tiles = m_tiles * n_tiles
    tile_groups = next(r for r in (8, 4, 2, 1) if r <= min(tiles, WARPS))
    k_splits = min(WARPS // tile_groups, k_pad // 8)
    operand_floats = k_pad * w_stride + chunk * (h + 2 * HALO) * x_stride + k_pad
    partial_floats = (k_splits - 1) * tiles * 128
    epilogue_floats = 3 * cpg + 2 * WARPS * chunk
    return ConvPlan(chunk, (n_groups, _ceil(bsz, chunk)), cpg, cpg_pad, k_pad, w_stride, x_stride,
                    m_tiles, n_tiles, tile_groups, k_splits, _ceil(tiles, tile_groups),
                    operand_floats, partial_floats, epilogue_floats,
                    4 * (max(operand_floats, partial_floats) + epilogue_floats))


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The built ``csrc/fused_conv.cu``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind("fused_conv", [p, p, p, p, p, p, p, i, i, i, i, i, f, i, p], M_LEN)


class FusedConv1dGnMish:
    """``conv(x, w, b, gamma, beta, n_groups, pre_bias=None, eps=1e-5)``,
    the JAX function's signature.

    ``launches`` counts kernel launches and ``plain_calls`` calls of the
    plain version; callers reset them to 0 to count one run.
    """

    def __init__(self):
        self.launches = 0
        self.plain_calls = 0

    @staticmethod
    def _check(x, w, b, gamma, beta, n_groups, pre_bias) -> None:
        if x.dim() != 3:
            raise ValueError(f"x must be (B, H, Cin), got {tuple(x.shape)}")
        bsz, _, cin = x.shape
        if w.dim() != 3 or w.shape[0] != KERNEL_SIZE or w.shape[1] != cin:
            raise ValueError(f"w must be ({KERNEL_SIZE}, {cin}, Cout), got {tuple(w.shape)}")
        cout = w.shape[2]
        for name, v in (("b", b), ("gamma", gamma), ("beta", beta)):
            if tuple(v.shape) != (cout,):
                raise ValueError(f"{name} must be ({cout},), got {tuple(v.shape)}")
        if pre_bias is not None and tuple(pre_bias.shape) != (bsz, cin):
            raise ValueError(f"pre_bias must be ({bsz}, {cin}), got {tuple(pre_bias.shape)}")
        if n_groups < 1 or cout % n_groups:
            raise ValueError(f"Cout {cout} is not a multiple of n_groups {n_groups}")
        tensors = [x, w, b, gamma, beta] + ([] if pre_bias is None else [pre_bias])
        if any(t.dtype != torch.float32 for t in tensors):
            raise ValueError("every tensor must be float32")
        if any(t.device != x.device for t in tensors):
            raise ValueError("every tensor must lie on x's device")

    def __call__(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, n_groups: int, pre_bias: Optional[torch.Tensor] = None,
                 eps: float = 1e-5) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.plain(x, w, b, gamma, beta, n_groups, pre_bias, eps)
        return self.kernel(x, w, b, gamma, beta, n_groups, pre_bias, eps)

    @torch.no_grad()
    def kernel(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
               beta: torch.Tensor, n_groups: int, pre_bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
        """Checks the call against the kernel's plan, allocates the output and
        launches ``csrc/fused_conv.cu`` on the current stream (``_launch``)."""
        self._check(x, w, b, gamma, beta, n_groups, pre_bias)
        tensors = [x, w, b, gamma, beta] + ([] if pre_bias is None else [pre_bias])
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the fused_conv kernel takes contiguous tensors")
        bsz, h, cin = x.shape
        cout = w.shape[2]
        plan = conv_plan(bsz, h, cin, cout, int(n_groups))
        if plan.smem_bytes > SMEM_LIMIT:
            raise ValueError(f"the fused_conv kernel needs {plan.smem_bytes} B of shared memory, "
                             f"over {SMEM_LIMIT}")
        if plan.tiles_per_warp > MAX_TILES_PER_WARP:
            raise ValueError(f"the fused_conv kernel holds at most {MAX_TILES_PER_WARP} output "
                             f"tiles per warp in registers; {plan.chunk * h} rows x {plan.cpg} "
                             f"channels need {plan.tiles_per_warp}")
        out = torch.empty((bsz, h, cout), dtype=torch.float32, device=x.device)
        self._launch(x, w, b, gamma, beta, pre_bias, out, int(n_groups), float(eps))
        return out

    def _launch(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor, pre_bias: Optional[torch.Tensor], out: torch.Tensor,
                n_groups: int, eps: float, lib: Optional[ctypes.CDLL] = None) -> None:
        """The launch alone, on ``kernel``'s checked tensors and its output
        ``out`` (B, H, Cout): the one place a launch is counted. ``lib`` is
        the port's built ``csrc/fused_conv.cu`` unless another build of it is
        given, as ``scripts/conv_profile.py`` gives its instrumented copy.
        Refuses tensors off the card before it reads any library."""
        if not (x.is_cuda and out.is_cuda):
            raise ValueError("the fused_conv kernel takes CUDA tensors")
        bsz, h, cin = x.shape
        cout = w.shape[2]
        _build.launch(
            _kernel_lib() if lib is None else lib, "fused_conv",
            x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            None if pre_bias is None else pre_bias.data_ptr(), out.data_ptr(),
            bsz, h, cin, cout, n_groups, eps, conv_plan(bsz, h, cin, cout, n_groups).smem_bytes,
            torch.cuda.current_stream(out.device).cuda_stream)
        self.launches += 1

    def plain(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor, n_groups: int, pre_bias: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
        """``conv1d_gn_mish_reference`` after the kernel's shape checks."""
        self._check(x, w, b, gamma, beta, n_groups, pre_bias)
        self.plain_calls += 1
        return conv1d_gn_mish_reference(x, w, b, gamma, beta, n_groups, pre_bias, eps)


# The JAX package's function: one wrapper, whose counts a run resets and reads.
fused_conv1d_gn_mish = FusedConv1dGnMish()
