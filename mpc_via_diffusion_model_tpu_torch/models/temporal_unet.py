"""The temporal 1-D conv U-Net denoiser with 'default' (FiLM) conditioning:
port of ``mpc_via_diffusion_model_tpu/models/temporal_unet.py::TemporalUnet``.

Input and output are (batch, horizon, state_dim), the JAX package's layout.
A dropped context (``context_mask`` = 1) is zeroed; with ``cfg_indicator``
the conditioning vector also carries the context-present bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .layers import (Conv1dBlock, Downsample1d, ResidualTemporalBlock, TimeEncoder,
                     Upsample1d, group_norm_n_groups)

__all__ = ["TemporalUnet"]


class TemporalUnet(nn.Module):
    def __init__(
        self,
        state_dim: int,
        n_support_points: int = 32,
        unet_input_dim: int = 32,
        dim_mults: Sequence[int] = (1, 2, 4),
        time_emb_dim: int = 32,
        context_dim: int = 0,
        cfg_indicator: bool = False,
    ):
        super().__init__()
        self.state_dim = state_dim
        self.n_support_points = n_support_points
        self.unet_input_dim = unet_input_dim
        self.dim_mults = tuple(dim_mults)
        self.time_emb_dim = time_emb_dim
        self.context_dim = context_dim
        self.cfg_indicator = cfg_indicator

        cond_dim = time_emb_dim + context_dim + (1 if cfg_indicator else 0)
        dims = [state_dim] + [unet_input_dim * m for m in self.dim_mults]
        self.in_out = list(zip(dims[:-1], dims[1:]))
        n_levels = len(self.in_out)

        self.time_mlp = TimeEncoder(32, time_emb_dim)
        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(self.in_out):
            is_last = ind >= n_levels - 1
            self.downs.append(nn.ModuleList([
                ResidualTemporalBlock(dim_in, dim_out, cond_dim),
                ResidualTemporalBlock(dim_out, dim_out, cond_dim),
                nn.Identity(), nn.Identity(),
                Downsample1d(dim_out) if not is_last else nn.Identity(),
            ]))
        mid_dim = dims[-1]
        self.mid_block1 = ResidualTemporalBlock(mid_dim, mid_dim, cond_dim)
        self.mid_block2 = ResidualTemporalBlock(mid_dim, mid_dim, cond_dim)
        self.ups = nn.ModuleList()
        for dim_in, dim_out in reversed(self.in_out[1:]):
            # every up level upsamples: with n levels there are n-1 up levels
            self.ups.append(nn.ModuleList([
                ResidualTemporalBlock(dim_out * 2, dim_in, cond_dim),
                ResidualTemporalBlock(dim_in, dim_in, cond_dim),
                nn.Identity(), nn.Identity(),
                Upsample1d(dim_in),
            ]))
        self.final_conv = nn.Sequential(
            Conv1dBlock(unet_input_dim, unet_input_dim, 5, group_norm_n_groups(unet_input_dim)),
            nn.Conv1d(unet_input_dim, state_dim, 1),
        )

    def conditioning(self, time: torch.Tensor, context: torch.Tensor,
                     context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """cat(time embedding, context, [present bit]); a dropped context is zeroed."""
        if context_mask is not None:
            context = context * (1.0 - context_mask)
        parts = [self.time_mlp(time), context]
        if self.cfg_indicator:
            if context_mask is not None:
                parts.append(1.0 - context_mask)
            else:
                parts.append(torch.ones((context.shape[0], 1), dtype=context.dtype,
                                        device=context.device))
        return torch.cat(parts, dim=-1)

    def forward(self, x: torch.Tensor, time: torch.Tensor, context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, H, D); time (B,); context (B, C); context_mask (B, 1), 1 = drop."""
        y = self.features(x, self.conditioning(time, context, context_mask))
        return self.final_conv[1](y.transpose(1, 2)).transpose(1, 2)

    def features(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """The conv backbone up to the final Conv1dBlock: x (B, H, D) and the
        conditioning vector c (B, cond_dim) -> (B, H, unet_input_dim), the
        part of the forward that the U-Net pass kernel computes."""
        h = x.transpose(1, 2)
        skips = []
        for rb1, rb2, _, _, down in self.downs:
            h = rb2(rb1(h, c), c)
            skips.append(h)
            h = down(h)
        h = self.mid_block2(self.mid_block1(h, c), c)
        for rb1, rb2, _, _, up in self.ups:
            h = torch.cat([h, skips.pop()], dim=1)
            h = up(rb2(rb1(h, c), c))
        return self.final_conv[0](h).transpose(1, 2)

    def padding_taps(self) -> Dict[str, torch.Tensor]:
        """Per conv weight name, a bool mask of the kernel entries that read
        only the conv's zero padding at ``n_support_points`` (taps 0 and 4
        of a k = 5 conv on 2 rows): their gradient is exactly 0, so
        training must leave them at their initial values."""
        lengths, hooks = {}, []
        for name, mod in self.named_modules():
            if isinstance(mod, nn.Conv1d):
                hooks.append(mod.register_forward_hook(
                    lambda m, args, out, name=name: lengths.__setitem__(name, args[0].shape[-1])))
        p = next(self.parameters())
        with torch.no_grad():
            self(torch.zeros((1, self.n_support_points, self.state_dim), dtype=p.dtype,
                             device=p.device), torch.zeros(1, dtype=torch.long, device=p.device),
                 torch.zeros((1, self.context_dim), dtype=p.dtype, device=p.device))
        for h in hooks:
            h.remove()
        out = {}
        for name, length in lengths.items():
            conv = self.get_submodule(name)
            (k,), (pad,), (stride,) = conv.kernel_size, conv.padding, conv.stride
            taps = torch.arange(k)
            # tap j reads rows j - pad, j - pad + stride, ..., all outside [0, length)
            last = taps - pad + stride * ((length + 2 * pad - k) // stride)
            dead = (taps - pad >= length) | (last < 0)
            if dead.any():
                out[name + ".weight"] = dead.expand_as(conv.weight).to(conv.weight.device)
        return out

    def res_blocks(self):
        """The ResidualTemporalBlocks in call order: the flax package numbers
        them ``ResidualTemporalBlock_0 .. _{n_res-1}`` in this order."""
        out = []
        for blocks in self.downs:
            out += [blocks[0], blocks[1]]
        out += [self.mid_block1, self.mid_block2]
        for blocks in self.ups:
            out += [blocks[0], blocks[1]]
        return out
