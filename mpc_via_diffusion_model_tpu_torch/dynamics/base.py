"""Plant and quadratic cost on torch tensors: port of
``mpc_via_diffusion_model_tpu/dynamics/base.py`` (``Plant``, ``QuadraticCost``).
State stays fp32."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["Plant", "QuadraticCost"]


@dataclasses.dataclass(frozen=True)
class Plant:
    """A discrete-time plant ``x_{k+1} = step(x_k, u_k)``; ``x`` is
    (state_dim,), ``u`` is (control_dim,)."""

    name: str
    state_dim: int
    control_dim: int
    dt: float
    step: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class QuadraticCost:
    """Stage ``x'Qx + u'Ru`` and terminal ``x'Px`` with diagonal Q, P."""

    q_diag: torch.Tensor
    r: torch.Tensor
    p_diag: torch.Tensor

    def to(self, device) -> "QuadraticCost":
        return QuadraticCost(self.q_diag.to(device), self.r.to(device), self.p_diag.to(device))

    def stage(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.q_diag * torch.square(x)) + torch.sum(self.r * torch.square(u))

    def terminal(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.p_diag * torch.square(x))
