"""One U-Net forward with its conv backbone as one CUDA kernel, beside its
plain PyTorch version.

Port of ``mpc_via_diffusion_model_tpu/ops/fused_unet.py::make_fused_unet``.
``make_fused_unet`` returns a ``FusedUnet``, an ``nn.Module`` built for a
fixed batch size: ``forward(x, t, context, context_mask) -> eps`` launches
``csrc/fused_unet.cu`` when the tensors lie on a CUDA device and runs
``FusedUnet.plain`` when they lie on the CPU. On a CUDA tensor it launches
the kernel or raises: it never falls back to the plain version there.

As in the JAX package, the time MLP, the context masking with the
context-present bit, the FiLM biases and the final 1x1 conv stay outside the
kernel (fused_unet.py:414-450); the kernel runs the conv backbone from the
input rows to the final Conv1dBlock. ``bench.py``'s ``BENCH_FUSED=1`` path
passes it as the denoiser of the plain sampler, at batch 2 (the CFG
doubling of one sample).

The kernel runs each batch row on a thread-block cluster of 8 CTAs that
splits the U-Net body by output channel, one GroupNorm group per CTA
(``csrc/unet_body_cluster.cuh``), on the one-row-set plan of shared memory
(``unet_pack``, ``metas[1]``): it needs a card with clusters (sm_90), a
model whose convs and GroupNorms ``unet_pack.cluster_split`` accepts and a
plan that one block can hold. All three are checked where the kernel would
be launched (``_build.ClusterLaunch``), so the plain version on the CPU
takes any model.

``make_fused_unet`` takes the JAX builder's ``weights_dtype``: float32, or
bfloat16, which launches the kernel's bf16 entry (``fused_unet_bf16``: the
body's conv kernels read as bf16, every product's activation operand
rounded to bf16) and gives ``plain`` the backbone of
``models/bf16.py::bf16_conv_copy(model, round_final_1x1=False)``. The final
1x1 conv stays fp32 on an unrounded y in both, as the JAX builder computes
it outside its kernel (fused_unet.py:450).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch
from torch import nn

from ..models.bf16 import bf16_conv_copy
from ..models.layers import mish
from ..models.temporal_unet import TemporalUnet
from . import _build
from .fused_denoise import is_bf16
from .unet_pack import CLUSTER, M_LEN, PackedUnet, packed_on

__all__ = ["FusedUnet", "make_fused_unet", "fused_unet_max_active_clusters"]

ROW_SETS = 1  # the kernel's row-sets: one batch row per cluster


@functools.lru_cache(maxsize=None)
def _kernel_lib(entry: str = "fused_unet") -> ctypes.CDLL:
    """The built ``csrc/fused_unet.cu``, ``entry`` declared (``fused_unet``,
    or ``fused_unet_bf16``, which takes the bf16 copy of the weights
    second)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    weights = [p, p] if entry.endswith("_bf16") else [p]
    return _build.bind(entry, [*weights, p, i, p, p, p, i, p], M_LEN, cluster=CLUSTER,
                       source="fused_unet")


def fused_unet_max_active_clusters(smem_bytes: int, entry: str = "fused_unet") -> int:
    """How many clusters of the U-Net pass kernel's ``entry`` (one per batch
    row) fit on the current CUDA device at once with ``smem_bytes`` of
    dynamic shared memory per CTA (``cudaOccupancyMaxActiveClusters``);
    raises with CUDA's text when the query fails. Builds the kernel first if
    needed."""
    return _build.max_active_clusters(_kernel_lib(entry), entry, smem_bytes)


class FusedUnet(nn.Module):
    """``forward(x (B, H, D), t (B,), context (B, C), context_mask (B, 1))
    -> eps (B, H, D)`` for the batch size B it was built for.

    ``launches`` counts kernel launches and ``plain_calls`` calls of the
    plain version; callers reset them to 0 to count one run. ``cluster``
    holds the rank-major weights the kernel reads and its occupancy check.
    ``entry`` is the kernel's entry: ``fused_unet_bf16`` for bf16 weights,
    whose ``plain`` runs the backbone of ``plain_model`` (the U-Net with bf16
    convs but its final 1x1 conv, ``models/bf16.py``).
    """

    def __init__(self, packed: PackedUnet, batch_size: int, weights_dtype=torch.float32):
        super().__init__()
        self.packed = packed
        self.model = packed.model
        self.batch_size = int(batch_size)
        self.bf16 = is_bf16(weights_dtype)
        self.plain_model = (bf16_conv_copy(self.model, round_final_1x1=False) if self.bf16
                            else self.model)
        self.entry = "fused_unet_bf16" if self.bf16 else "fused_unet"
        # the one-row-set plan: the meta table the kernel reads and its shared memory per CTA
        self.meta, self.smem_bytes = packed.metas[ROW_SETS], packed.chain_smem_bytes(ROW_SETS)
        self.cluster = _build.ClusterLaunch(
            packed, self.entry, functools.partial(fused_unet_max_active_clusters, entry=self.entry))
        self.launches = 0
        self.plain_calls = 0

    def _check(self, x: torch.Tensor, context: torch.Tensor) -> None:
        b, h, d = self.batch_size, self.packed.horizon, self.packed.state_dim
        if x.shape[0] != b:
            raise ValueError(f"fused U-Net built for batch {b}, got {x.shape[0]}")
        if tuple(x.shape) != (b, h, d):
            raise ValueError(f"x must be {(b, h, d)}, got {tuple(x.shape)}")
        if tuple(context.shape) != (b, self.model.context_dim):
            raise ValueError(f"context must be ({b}, {self.model.context_dim}), got {tuple(context.shape)}")
        if x.dtype != torch.float32 or context.dtype != torch.float32:
            raise ValueError("x and context must be float32")

    def films(self, c: torch.Tensor) -> torch.Tensor:
        """(n_res, B, max_c) FiLM biases ``mish(c) @ Wf_r + bf_r`` of the
        conditioning vectors c = ``TemporalUnet.conditioning`` (time
        embedding, masked context, present bit; fused_unet.py:413-436)."""
        return (torch.einsum("bc,rcd->rbd", mish(c), self.packed.films_w)
                + self.packed.films_b[:, None, :])

    def final_1x1(self, y: torch.Tensor) -> torch.Tensor:
        """(B, H, unet_input_dim) -> eps (B, H, D)."""
        return self.model.final_conv[1](y.transpose(1, 2)).transpose(1, 2)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.plain(x, t, context, context_mask)
        return self.kernel(x, t, context, context_mask)

    @torch.no_grad()
    def kernel(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
               context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The conv backbone through ``csrc/fused_unet.cu``'s ``entry``, one
        cluster of 8 CTAs per batch row, on the current stream; raises when
        the body cannot be split over the cluster, its plan is more than a
        block may take or no cluster fits on the card."""
        self._check(x, context)
        if not x.is_cuda or x.device != self.packed.weights.device:
            raise ValueError(f"the {self.entry} kernel takes tensors on the packed weights' CUDA "
                             "device")
        weights = self.cluster.weights
        self.cluster.require_fit(self.smem_bytes, x.device)
        films = self.films(self.model.conditioning(t, context, context_mask)).contiguous()
        y = torch.empty((self.batch_size, self.packed.horizon, self.model.unet_input_dim),
                        dtype=torch.float32, device=x.device)
        self._launch(weights, films, x.contiguous(), y)
        return self.final_1x1(y)

    def _launch(self, weights: torch.Tensor, films: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor) -> None:
        """The launch alone, on ``kernel``'s checked and prepared tensors:
        the rank-major weights (the bf16 entry also reads their bf16 copy,
        ``cluster.weights_bf16``), films (n_res, B, max_c), x (B, H, D) and
        y (B, H, unet_input_dim)."""
        bf16 = [self.cluster.weights_bf16.data_ptr()] if self.bf16 else []
        _build.launch(
            _kernel_lib(self.entry), self.entry,
            weights.data_ptr(), *bf16, self.meta.data_ptr(), self.smem_bytes,
            films.data_ptr(), x.data_ptr(), y.data_ptr(), self.batch_size,
            torch.cuda.current_stream(y.device).cuda_stream)
        self.launches += 1

    @torch.no_grad()
    def plain(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
              context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The same forward with the backbone through ``plain_model``'s
        ``TemporalUnet`` modules (``TemporalUnet.features``)."""
        self._check(x, context)
        self.plain_calls += 1
        y = self.plain_model.features(x, self.model.conditioning(t, context, context_mask))
        return self.final_1x1(y)


def make_fused_unet(model_or_packed: Union[TemporalUnet, PackedUnet], batch_size: int,
                    weights_dtype=torch.float32, device=None) -> FusedUnet:
    """Build the U-Net forward for a fixed ``batch_size`` on ``device``
    (``cuda`` unless given), with float32 or bfloat16 conv weights in the
    backbone (``weights_dtype``; any other type raises
    ``NotImplementedError``). A ``TemporalUnet`` is moved to the device and
    packed."""
    is_bf16(weights_dtype)
    return FusedUnet(packed_on(model_or_packed, device), batch_size, weights_dtype)
