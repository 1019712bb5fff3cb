"""Plant and quadratic cost on torch tensors: port of
``mpc_via_diffusion_model_tpu/dynamics/base.py`` (``Plant``, ``QuadraticCost``,
``rollout``, ``rollout_with_cost``, ``reference_mpc_cost``). State stays fp32.

Steps and costs take any leading batch axes: ``x`` is (..., state_dim) and
``u`` is (..., control_dim), which stands in for the JAX package's ``vmap``."""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

__all__ = ["Plant", "QuadraticCost", "rollout", "rollout_with_cost", "reference_mpc_cost"]


@dataclasses.dataclass(frozen=True)
class Plant:
    """A discrete-time plant ``x_{k+1} = step(x_k, u_k)``; ``x`` is
    (..., state_dim), ``u`` is (..., control_dim)."""

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
        return (torch.sum(self.q_diag * torch.square(x), dim=-1)
                + torch.sum(self.r * torch.square(u), dim=-1))

    def terminal(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.p_diag * torch.square(x), dim=-1)


def rollout(plant: Plant, x0: torch.Tensor, u_seq: torch.Tensor) -> torch.Tensor:
    """Roll the plant through ``u_seq`` (..., horizon, control_dim) from
    ``x0`` (..., state_dim); returns the (..., horizon + 1, state_dim)
    trajectory including ``x0``."""
    xs = [x0]
    for i in range(u_seq.shape[-2]):
        xs.append(plant.step(xs[-1], u_seq[..., i, :]))
    return torch.stack(xs, dim=-2)


def rollout_with_cost(plant: Plant, cost: QuadraticCost, x0: torch.Tensor,
                      u_seq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rollout and quadratic cost together: stage cost on x_0 .. x_{H-1} and
    every control, terminal cost on x_H. Returns (states (..., H + 1, d),
    total cost (...))."""
    xs, acc = [x0], torch.zeros(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    for i in range(u_seq.shape[-2]):
        u = u_seq[..., i, :]
        acc = acc + cost.stage(xs[-1], u)
        xs.append(plant.step(xs[-1], u))
    return torch.stack(xs, dim=-2), acc + cost.terminal(xs[-1])


def reference_mpc_cost(plant: Plant, cost: QuadraticCost, x0: torch.Tensor,
                       u_seq: torch.Tensor) -> torch.Tensor:
    """The reference's closed-loop cost metric ``calMPCCost``, quirks kept,
    as mpc_via_diffusion_model_tpu/dynamics/base.py:126-159 keeps them: the
    full Q cost of x0 plus R on u_0; stage terms for i = 1 .. H-2 that skip
    state dimension 0 and add R u_i^2; the final P term on x_{H-2} rolled
    one step, not on x_H. ``x0`` is (..., d), ``u_seq`` (..., H, m);
    returns (...)."""
    horizon = u_seq.shape[-2]
    u_sq = lambda u: torch.sum(cost.r * torch.square(u), dim=-1)
    acc = torch.sum(cost.q_diag * torch.square(x0), dim=-1) + u_sq(u_seq[..., 0, :])
    x, u = x0, u_seq[..., 0, :]
    for i in range(1, horizon - 1):
        x = plant.step(x, u)
        u = u_seq[..., i, :]
        acc = acc + torch.sum(cost.q_diag[1:] * torch.square(x[..., 1:]), dim=-1)
        acc = acc + u_sq(u)
    return acc + torch.sum(cost.p_diag * torch.square(x), dim=-1)
