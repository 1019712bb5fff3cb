"""Dataset normalizers: port of ``mpc_via_diffusion_model_tpu/data/normalization.py``
(``NormalizerStats``, ``fit_normalizer``, ``normalize``, ``unnormalize``,
``canonical_kind``, ``DatasetNormalizer``).

The 'limits' kind maps [min, max] to [-1, 1], and its ``unnormalize`` clips
to [-1, 1] first: sampled controls saturate at the dataset limits.
'safe_limits' and 'fixed_limits' are fitted into 'limits' statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["NormalizerStats", "fit_normalizer", "normalize", "unnormalize", "canonical_kind",
           "DatasetNormalizer", "NORMALIZERS"]


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


def fit_normalizer(x, kind: str = "limits", eps: float = 1.0, fixed_min: float = -1.0,
                   fixed_max: float = 1.0) -> NormalizerStats:
    """Statistics of data (..., d), flattened to (N, d), in float32 numpy as
    the JAX function computes them: stds with Bessel's correction, at least
    1e-8. 'safe_limits' pads the WHOLE min and max vectors by eps once per
    constant dimension (the reference's quirk); 'fixed_limits' takes
    [fixed_min, fixed_max] in every dimension."""
    x2 = np.asarray(x, dtype=np.float32)
    x2 = x2 if x2.ndim == 2 else x2.reshape(-1, x2.shape[-1])
    mins, maxs, means = x2.min(axis=0), x2.max(axis=0), x2.mean(axis=0)
    stds = x2.std(axis=0, ddof=1) if x2.shape[0] > 1 else np.ones_like(means)
    stds = np.maximum(stds, 1e-8)
    if kind == "safe_limits":
        n_constant = int((mins == maxs).sum())
        mins, maxs, kind = mins - eps * n_constant, maxs + eps * n_constant, "limits"
    elif kind == "fixed_limits":
        mins, maxs = np.full_like(mins, fixed_min), np.full_like(maxs, fixed_max)
        kind = "limits"
    if kind not in ("limits", "gaussian", "identity"):
        raise ValueError(f"unknown normalizer kind '{kind}'")
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))
    return NormalizerStats(kind, t(mins), t(maxs), t(means), t(stds))


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


NORMALIZERS = ("limits", "gaussian", "identity", "safe_limits", "fixed_limits")

_REFERENCE_NAMES = {
    "LimitsNormalizer": "limits",
    "GaussianNormalizer": "gaussian",
    "Identity": "identity",
    "SafeLimitsNormalizer": "safe_limits",
    "FixedLimitsNormalizer": "fixed_limits",
}


def canonical_kind(name: str) -> str:
    """Accept both the kinds above and the reference's class names."""
    return _REFERENCE_NAMES.get(name, name)


@dataclasses.dataclass(frozen=True)
class DatasetNormalizer:
    """Per-field normalizers (the reference's ``DatasetNormalizer``)."""

    stats: Dict[str, NormalizerStats]

    @classmethod
    def fit(cls, fields: Dict[str, np.ndarray], kind: str = "limits") -> "DatasetNormalizer":
        kind = canonical_kind(kind)
        return cls(stats={k: fit_normalizer(v, kind) for k, v in fields.items()})

    def normalize(self, x: torch.Tensor, key: str) -> torch.Tensor:
        return normalize(self.stats[key], x)

    def unnormalize(self, x: torch.Tensor, key: str) -> torch.Tensor:
        return unnormalize(self.stats[key], x)
