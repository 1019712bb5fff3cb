"""Layers of the temporal U-Net as ``nn.Module``s: port of
``mpc_via_diffusion_model_tpu/models/layers.py``.

Modules here work in torch's (batch, channels, horizon) layout; the U-Net
transposes at its boundary so its public layout stays the JAX package's
(batch, horizon, channels). Submodule names and indices follow the
reference's torch model (``time_mlp.encoder.1``, ``blocks.0.block.0``,
``cond_mlp.1``, ``residual_conv``, ``conv``), so a state dict maps onto it
as ``models/torch_import.py`` documents; ``nn.Identity`` fills the indices
that hold the reference's ``Rearrange`` layers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "mish",
    "Mish",
    "group_norm_n_groups",
    "SinusoidalPosEmb",
    "TimeEncoder",
    "Conv1dBlock",
    "ResidualTemporalBlock",
    "Downsample1d",
    "Upsample1d",
    "MLP",
    "TemporalBlockMLP",
]


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)); ``F.softplus`` is the stable form (it returns
    x itself above 20, where log1p(exp(x)) would overflow)."""
    return x * torch.tanh(F.softplus(x))


class Mish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(x)


def group_norm_n_groups(n_channels: int, target_n_groups: int = 8) -> int:
    """Smallest divisor >= 8 of the channel count, else 1 (8 groups at 32,
    64 and 128 channels)."""
    if n_channels < target_n_groups:
        return 1
    for n_groups in range(target_n_groups, target_n_groups + 10):
        if n_channels % n_groups == 0:
            return n_groups
    return 1


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        emb_scale = math.log(10000.0) / (half_dim - 1)
        freqs = torch.exp(
            torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb_scale)
        args = t.to(torch.float32)[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class TimeEncoder(nn.Module):
    """SinusoidalPosEmb(dim) -> Linear(4 dim) -> Mish -> Linear(dim_out)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.encoder = nn.Sequential(
            SinusoidalPosEmb(dim), nn.Linear(dim, dim * 4), Mish(), nn.Linear(dim * 4, dim_out))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        """The embedding is float32, as in the JAX package, and the MLP runs
        in its weights' dtype (float64 for a reference run)."""
        emb, *mlp = self.encoder
        h = emb(t).to(mlp[0].weight.dtype)
        for layer in mlp:
            h = layer(h)
        return h


class Conv1dBlock(nn.Module):
    """Conv1d(k, 'same') -> GroupNorm(eps 1e-5) -> Mish."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5,
                 n_groups: int = 8):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv1d(in_channels, out_channels, kernel_size, padding=kernel_size // 2),
            nn.Identity(),
            nn.GroupNorm(n_groups, out_channels, eps=1e-5),
            nn.Identity(),
            Mish(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class ResidualTemporalBlock(nn.Module):
    """Two Conv1dBlocks with the FiLM bias Linear(mish(c)) added after the
    first, plus a 1x1-conv residual when the channel count changes."""

    def __init__(self, in_channels: int, out_channels: int, cond_dim: int,
                 kernel_size: int = 5):
        super().__init__()
        groups = group_norm_n_groups(out_channels)
        self.blocks = nn.ModuleList([
            Conv1dBlock(in_channels, out_channels, kernel_size, groups),
            Conv1dBlock(out_channels, out_channels, kernel_size, groups),
        ])
        self.cond_mlp = nn.Sequential(Mish(), nn.Linear(cond_dim, out_channels))
        self.residual_conv = (nn.Conv1d(in_channels, out_channels, 1)
                              if in_channels != out_channels else nn.Identity())

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        h = self.blocks[0](x) + self.cond_mlp(c)[:, :, None]
        h = self.blocks[1](h)
        return h + self.residual_conv(x)


class Downsample1d(nn.Module):
    """Conv1d(k3, s2, p1): halves the horizon."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample1d(nn.Module):
    """The JAX package's flax ``ConvTranspose(k4, s2, padding=[(2, 2)])``,
    which does not flip its kernel:
    ``out[2t] = w0 x[t-1] + w2 x[t]`` and ``out[2t+1] = w1 x[t] + w3 x[t+1]``.
    torch's ``ConvTranspose1d(k4, s2, p1)`` computes exactly that with the
    kernel flipped along k, so ``models/weights.py`` flips it on load."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose1d(dim, dim, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class MLP(nn.Module):
    """Linear(hidden), act, Linear(out): the JAX package's ``MLP`` with ``n_layers=0``, the
    only form its ``PointUnet`` builds. ``act`` is a callable (``mish`` in a block, the
    identity in ``PointUnet.final``). ``first`` and ``last`` are flax's ``Dense_0`` and
    ``Dense_1``."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int, act=lambda x: x):
        super().__init__()
        self.act = act
        self.first = nn.Linear(in_dim, hidden_dim)
        self.last = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.last(self.act(self.first(x)))


class TemporalBlockMLP(nn.Module):
    """mish(MLP(x) + Linear(mish(c))), the MLP one hidden layer of ``out_channels`` with mish:
    the JAX package's ``TemporalBlockMLP``, a block of ``PointUnet``."""

    def __init__(self, in_channels: int, out_channels: int, cond_dim: int):
        super().__init__()
        self.mlp = MLP(in_channels, out_channels, hidden_dim=out_channels, act=mish)
        self.cond = nn.Linear(cond_dim, out_channels)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return mish(self.mlp(x) + self.cond(mish(c)))
