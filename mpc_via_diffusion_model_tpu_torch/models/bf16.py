"""The temporal U-Net with bf16 conv weights, in plain PyTorch: the function
the JAX kernels compute with ``weights_dtype=jnp.bfloat16``
(``mpc_via_diffusion_model_tpu/ops/fused_unet.py::build_unet_ops``).

There every conv kernel of the U-Net (the two k5 convs and the 1x1 residual
conv of each ResidualTemporalBlock, the downsample, the transposed upsample,
the final Conv1dBlock's conv and the final 1x1 conv) is stored in bf16,
rounded to nearest even, and every product rounds its activation operand to
bf16 and accumulates in fp32 (``xs.astype(w.dtype)``, fused_unet.py:108,
:279, :313; ``y.astype(weights_dtype)`` before the final 1x1 conv). Conv
biases, GroupNorm, the FiLM Dense layers and the time MLP stay fp32. The
product of two bf16 numbers is exact in fp32, so a float32 conv on
bf16-rounded weights and inputs computes the same function up to the order
of its fp32 sums.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from .temporal_unet import TemporalUnet

__all__ = ["round_bf16", "bf16_conv_copy"]


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 to nearest even, kept in x's own type."""
    return x.to(torch.bfloat16).to(x.dtype)


def _round_input(module: nn.Module, args):
    return (round_bf16(args[0]),) + tuple(args[1:])


@torch.no_grad()
def bf16_conv_copy(model: TemporalUnet) -> TemporalUnet:
    """A copy of ``model`` whose ``Conv1d`` and ``ConvTranspose1d`` layers
    hold bf16-rounded weights and round their input to bf16; their biases and
    every other layer are ``model``'s own values. ``model`` is unchanged."""
    out = copy.deepcopy(model)
    for module in out.modules():
        if isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)):
            module.weight.copy_(round_bf16(module.weight))
            module.register_forward_pre_hook(_round_input)
    return out
