"""The cart-pole plants of ``mpc_via_diffusion_model_tpu/dynamics/cartpole.py``,
fp32, each step taking leading batch axes (x (..., d), u (..., 1)):

- ``cartpole_lmpc``: the 4-state linear cart-pole, zero-order hold at
  dt = 0.1 (the LMPC parity workload), with ``cartpole_lmpc_cost``;
- ``cartpole_virtual_swingup``: the 5-state nonlinear swing-up cart-pole
  with the virtual angle state theta*, Euler forward at dt = 0.01, with
  ``cartpole_virtual_cost`` and ``cartpole_virtual_collect_cost``;
- ``cartpole_virtual_stabilized``: the alternative 5-state spring/damper
  model with the same virtual state, Euler forward at dt = 0.01;

and ``theta_to_red_theta``."""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import Plant, QuadraticCost

__all__ = ["theta_to_red_theta", "cartpole_lmpc", "cartpole_lmpc_cost",
           "cartpole_virtual_swingup", "cartpole_virtual_stabilized", "cartpole_virtual_cost",
           "cartpole_virtual_collect_cost"]


def theta_to_red_theta(theta):
    """theta* = (theta - pi)^2 / (-pi) + pi: both swing-up directions map to
    the target theta* = 0. Python floats stay float64, tensors keep dtype."""
    return (theta - math.pi) ** 2 / (-math.pi) + math.pi


_LMPC_A = np.array([[0.0, 1.0, 0.0, 0.0],
                    [0.0, -0.1, 3.0, 0.0],
                    [0.0, 0.0, 0.0, 1.0],
                    [0.0, -0.5, 30.0, 0.0]])
_LMPC_B = np.array([[0.0], [2.0], [0.0], [5.0]])


def _zoh_discretize(a: np.ndarray, b: np.ndarray, dt: float):
    """Exact zero-order hold: expm([[A, B], [0, 0]] dt) = [[A_d, B_d], [0, I]],
    by the JAX package's float64 scaling-and-squaring series (a copy of
    mpc_via_diffusion_model_tpu/dynamics/cartpole.py:_zoh_discretize, so the
    two give the same bits). Returns float64 (A_d (n, n), B_d (n, m))."""
    n, m = a.shape[0], b.shape[1]
    aug = np.zeros((n + m, n + m))
    aug[:n, :n] = a
    aug[:n, n:] = b
    s = max(0, int(np.ceil(np.log2(max(1e-16, np.linalg.norm(aug * dt, ord=1))))) + 1)
    x = aug * dt / (2.0 ** s)
    term = np.eye(n + m)
    out = np.eye(n + m)
    for k in range(1, 20):
        term = term @ x / k
        out = out + term
    for _ in range(s):
        out = out @ out
    return out[:n, :n], out[:n, n:]


def cartpole_lmpc(dt: float = 0.1) -> Plant:
    """x' = A_d x + B_d u with A_d, B_d rounded to float32, each row summed
    in a fixed order, ((a_i0 x0 + a_i1 x1) + a_i2 x2) + a_i3 x3, then + b_i u,
    so that the episode kernel's device function (``csrc/plants.cuh``,
    ``CartpoleLmpc``) gives the same bits. ``device_consts`` are A_d row-major
    and B_d, the fp32 numbers that function reads."""
    a_d, b_d = (v.astype(np.float32) for v in _zoh_discretize(_LMPC_A, _LMPC_B, dt))
    a = [[float(v) for v in row] for row in a_d]
    b = [float(v) for v in b_d[:, 0]]

    def step(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        uu = u[..., 0]
        rows = []
        for ai, bi in zip(a, b):
            acc = ai[0] * x[..., 0]
            for j in range(1, 4):
                acc = acc + ai[j] * x[..., j]
            rows.append(acc + bi * uu)
        return torch.stack(rows, dim=-1)

    return Plant(name="cartpole_lmpc", state_dim=4, control_dim=1, dt=dt, step=step,
                 device_consts=tuple(v for row in a for v in row) + tuple(b))


def cartpole_lmpc_cost() -> QuadraticCost:
    """Q = diag(10, 1, 10, 1), R = 1, P = diag(100, 1, 100, 1)."""
    return QuadraticCost(
        q_diag=torch.tensor([10.0, 1.0, 10.0, 1.0], dtype=torch.float32),
        r=torch.tensor(1.0, dtype=torch.float32),
        p_diag=torch.tensor([100.0, 1.0, 100.0, 1.0], dtype=torch.float32),
    )


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


_M_CAR2 = 4.5
_M_POLE2 = 0.12
_L_PEND = 0.14
_K_SPRING = 0.5
_C_DAMP = 0.002
_I_POLE = (_M_POLE2 * _L_PEND ** 2) / 3.0
_V1 = (_M_CAR2 + _M_POLE2) / (_I_POLE * (_M_CAR2 + _M_POLE2) + (_L_PEND ** 2) * _M_POLE2 * _M_CAR2)
_V2 = (_I_POLE + (_L_PEND ** 2) * _M_POLE2) / (
    _I_POLE * (_M_CAR2 + _M_POLE2) + (_L_PEND ** 2) * _M_POLE2 * _M_CAR2)


def cartpole_virtual_stabilized(dt: float = 0.01) -> Plant:
    def step(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        uu = u[..., 0]
        x1, x2, x3 = x[..., 1], x[..., 2], x[..., 3]
        xddot = (-_K_SPRING * _V2 * x1
                 + ((_L_PEND * _M_POLE2) ** 2) * _G * _V2 / (_I_POLE + (_L_PEND ** 2) * _M_POLE2) * x2
                 - _L_PEND * _M_POLE2 * _C_DAMP * _V2 / (_I_POLE + (_L_PEND ** 2) * _M_POLE2) * x3
                 + _V2 * uu)
        tddot = (-_L_PEND * _M_POLE2 * _K_SPRING * _V1 / (_M_CAR2 + _M_POLE2) * x1
                 + _L_PEND * _M_POLE2 * _G * _V1 * x2
                 - _C_DAMP * _V1 * x3
                 + _L_PEND * _M_POLE2 * _V1 / (_M_CAR2 + _M_POLE2) * uu)
        xdot = torch.stack([x1, xddot, x3, tddot, -_PI_UNDER_2 * (x2 - math.pi) * x3], dim=-1)
        return x + xdot * dt

    return Plant(name="cartpole_virtual_stabilized", state_dim=5, control_dim=1, dt=dt, step=step)


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
