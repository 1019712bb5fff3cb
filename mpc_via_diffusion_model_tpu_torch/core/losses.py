"""Weighted elementwise losses: port of ``mpc_via_diffusion_model_tpu/core/losses.py``
(``weighted_l1``, ``weighted_l2``, ``LOSSES``).

Pure functions over tensors; the optional per-element weight tensor is an
argument. Each returns the mean over every element.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

__all__ = ["weighted_l1", "weighted_l2", "LOSSES"]


def _weighted(raw: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is not None:
        raw = raw * weights
    return torch.mean(raw)


def weighted_l1(pred: torch.Tensor, target: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean (optionally weighted) absolute error."""
    return _weighted(torch.abs(pred - target), weights)


def weighted_l2(pred: torch.Tensor, target: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean (optionally weighted) squared error."""
    return _weighted(torch.square(pred - target), weights)


LOSSES: Dict[str, Callable[..., torch.Tensor]] = {
    "l1": weighted_l1,
    "l2": weighted_l2,
}
