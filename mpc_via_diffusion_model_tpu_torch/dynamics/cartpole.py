"""The 5-state nonlinear swing-up cart-pole with the virtual angle state
theta* (port of ``mpc_via_diffusion_model_tpu/dynamics/cartpole.py``:
``cartpole_virtual_swingup``, ``cartpole_virtual_cost``,
``cartpole_virtual_collect_cost``, ``theta_to_red_theta``). Euler forward at dt=0.01, fp32. The step takes
leading batch axes: x (..., 5), u (..., 1)."""
from __future__ import annotations

import math

import torch

from .base import Plant, QuadraticCost

__all__ = ["theta_to_red_theta", "cartpole_virtual_swingup", "cartpole_virtual_cost",
           "cartpole_virtual_collect_cost"]


def theta_to_red_theta(theta):
    """theta* = (theta - pi)^2 / (-pi) + pi: both swing-up directions map to
    the target theta* = 0. Python floats stay float64, tensors keep dtype."""
    return (theta - math.pi) ** 2 / (-math.pi) + math.pi


_M_CART = 2.0
_M_POLE = 1.0
_M_TOTAL = _M_CART + _M_POLE
_L_POLE = 1.0
_MPLP = _M_POLE * _L_POLE
_G = 9.81
_MPG = _M_POLE * _G
_MTG = _M_TOTAL * _G
_MTLP = _M_TOTAL * _G  # sic: the reference sets MTLP = M_TOTAL * G, kept as in the JAX package
_PI_UNDER_2 = 2.0 / math.pi


def cartpole_virtual_swingup(dt: float = 0.01) -> Plant:
    def step(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        uu = u[..., 0]
        x1, x2, x3 = x[..., 1], x[..., 2], x[..., 3]
        sin_t = torch.sin(x2)
        cos_t = torch.cos(x2)
        xdot = torch.stack([
            x1,
            (_MPLP * -sin_t * x3 ** 2 + _MPG * sin_t * cos_t + uu)
            / (_M_TOTAL - _M_POLE * cos_t) ** 2,
            x3,
            (-_MPLP * sin_t * cos_t * x3 ** 2 - _MTG * sin_t - cos_t * uu)
            / (_MTLP - _MPLP * cos_t ** 2),
            -_PI_UNDER_2 * (x2 - math.pi) * x3,
        ], dim=-1)
        return x + xdot * dt

    return Plant(name="cartpole_virtual_swingup", state_dim=5, control_dim=1, dt=dt, step=step)


def cartpole_virtual_cost(q_redundant: float = 1000.0, p_redundant: float = 1000.0) -> QuadraticCost:
    """Q = diag(0.01, 0.01, 0, 0.001, 1000), R = 0.1, P likewise."""
    return QuadraticCost(
        q_diag=torch.tensor([0.01, 0.01, 0.0, 0.001, q_redundant], dtype=torch.float32),
        r=torch.tensor(0.1, dtype=torch.float32),
        p_diag=torch.tensor([0.01, 0.01, 0.0, 0.001, p_redundant], dtype=torch.float32),
    )


def cartpole_virtual_collect_cost() -> QuadraticCost:
    """The data-collection cost the distilled students are scored with:
    Q = diag(0.01, 0.01, 0, 0.01, 1000), R = 0.001, P = diag(0.01, 0.1, 0, 0.1, 1000)."""
    return QuadraticCost(
        q_diag=torch.tensor([0.01, 0.01, 0.0, 0.01, 1000.0], dtype=torch.float32),
        r=torch.tensor(0.001, dtype=torch.float32),
        p_diag=torch.tensor([0.01, 0.1, 0.0, 0.1, 1000.0], dtype=torch.float32),
    )
