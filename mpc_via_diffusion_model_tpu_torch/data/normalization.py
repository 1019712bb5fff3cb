"""Dataset normalizers: port of ``mpc_via_diffusion_model_tpu/data/normalization.py``
(``NormalizerStats``, ``normalize``, ``unnormalize``).

The 'limits' kind maps [min, max] to [-1, 1], and its ``unnormalize`` clips
to [-1, 1] first: sampled controls saturate at the dataset limits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["NormalizerStats", "normalize", "unnormalize"]


@dataclasses.dataclass(frozen=True)
class NormalizerStats:
    kind: str  # 'limits' | 'gaussian' | 'identity'
    mins: torch.Tensor
    maxs: torch.Tensor
    means: Optional[torch.Tensor] = None
    stds: Optional[torch.Tensor] = None

    def to(self, device) -> "NormalizerStats":
        move = lambda t: None if t is None else t.to(device)
        return NormalizerStats(self.kind, move(self.mins), move(self.maxs),
                               move(self.means), move(self.stds))


def normalize(stats: NormalizerStats, x: torch.Tensor) -> torch.Tensor:
    if stats.kind == "identity":
        return x
    if stats.kind == "gaussian":
        return (x - stats.means) / stats.stds
    return 2.0 * (x - stats.mins) / (stats.maxs - stats.mins) - 1.0


def unnormalize(stats: NormalizerStats, x: torch.Tensor) -> torch.Tensor:
    if stats.kind == "identity":
        return x
    if stats.kind == "gaussian":
        return x * stats.stds + stats.means
    x = torch.clamp(x, -1.0, 1.0)
    return (x + 1.0) * 0.5 * (stats.maxs - stats.mins) + stats.mins
