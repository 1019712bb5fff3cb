"""Fused Conv1d(k5, 'same') + optional FiLM pre-bias + GroupNorm + Mish as one
CUDA kernel, beside its plain PyTorch version.

Port of ``mpc_via_diffusion_model_tpu/ops/fused_conv.py``, with its signature
and the flax weight layout: x (B, H, Cin), w (5, Cin, Cout), b, gamma and beta
(Cout,), pre_bias (B, Cin) or None -> (B, H, Cout).
``fused_conv1d_gn_mish`` launches ``csrc/fused_conv.cu`` when the tensors lie
on a CUDA device and runs ``conv1d_gn_mish_reference`` when they lie on the
CPU. On a CUDA tensor it launches the kernel or raises: it never falls back
to the plain version there.

As in the JAX package, the block is on no model path: the U-Net kernels run
the same conv and GroupNorm inside their body (``csrc/unet_body.cuh``), and
``scripts/bench_kernels.py`` times this one against its plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..models.layers import mish
from . import _build
from .unet_pack import HALO, M_LEN, SMEM_LIMIT

__all__ = ["FusedConv1dGnMish", "fused_conv1d_gn_mish", "conv1d_gn_mish_reference",
           "conv_smem_bytes"]

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


def conv_smem_bytes(h: int, cin: int, cout: int, n_groups: int) -> int:
    """Shared memory of one block: the input and output activations with
    their HALO zero rows, and the (mean, 1/std) of every group."""
    return 4 * ((h + 2 * HALO) * (cin + cout) + 2 * n_groups)


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
        """Launch ``csrc/fused_conv.cu`` on the current stream."""
        self._check(x, w, b, gamma, beta, n_groups, pre_bias)
        tensors = [x, w, b, gamma, beta] + ([] if pre_bias is None else [pre_bias])
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the fused_conv kernel takes contiguous tensors")
        bsz, h, cin = x.shape
        cout = w.shape[2]
        smem = conv_smem_bytes(h, cin, cout, n_groups)
        if smem > SMEM_LIMIT:
            raise ValueError(f"the fused_conv kernel needs {smem} B of shared memory, over "
                             f"{SMEM_LIMIT}")
        if not x.is_cuda:
            raise ValueError("the fused_conv kernel takes CUDA tensors")
        out = torch.empty((bsz, h, cout), dtype=torch.float32, device=x.device)
        _build.launch(
            _kernel_lib(), "fused_conv",
            x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            None if pre_bias is None else pre_bias.data_ptr(), out.data_ptr(),
            bsz, h, cin, cout, int(n_groups), float(eps), smem,
            torch.cuda.current_stream(x.device).cuda_stream)
        self.launches += 1
        return out

    def plain(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor, n_groups: int, pre_bias: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
        """``conv1d_gn_mish_reference`` after the kernel's shape checks."""
        self._check(x, w, b, gamma, beta, n_groups, pre_bias)
        self.plain_calls += 1
        return conv1d_gn_mish_reference(x, w, b, gamma, beta, n_groups, pre_bias, eps)


# The JAX package's function: one wrapper, whose counts a run resets and reads.
fused_conv1d_gn_mish = FusedConv1dGnMish()
