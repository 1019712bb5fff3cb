"""The pendulum and the double integrator of
``mpc_via_diffusion_model_tpu/dynamics/simple_plants.py``, fp32, each step
taking leading batch axes (x (..., 2), u (..., 1)):

- ``pendulum``: the torque-actuated pendulum, state (theta, theta_dot),
  theta = 0 upright, Euler forward, with ``pendulum_cost``; the short-horizon
  PointUnet workload of ``scripts/bench_throughput.py``;
- ``double_integrator``: the 1-D double integrator, state (pos, vel), exact
  discretization, with ``double_integrator_cost``.

No episode kernel runs either plant (``ops/csrc/plants.cuh`` has no device
function for them): they run in ``control/runtime.py``'s loops and the
scripts' own loops.
"""
from __future__ import annotations

import torch

from .base import Plant, QuadraticCost

__all__ = ["pendulum", "pendulum_cost", "double_integrator", "double_integrator_cost"]


def pendulum(dt: float = 0.01, m: float = 1.0, l: float = 1.0, g: float = 9.81,
             b: float = 0.05) -> Plant:
    """Torque-actuated pendulum, state (theta, theta_dot), theta = 0 upright:
    theta_ddot = (g / l) sin(theta) - b / (m l^2) theta_dot + u / (m l^2), then
    x + xdot dt, in the JAX package's order."""

    def step(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        uu = u[..., 0]
        theta_ddot = (g / l) * torch.sin(x[..., 0]) - (b / (m * l * l)) * x[..., 1] + uu / (m * l * l)
        xdot = torch.stack([x[..., 1], theta_ddot], dim=-1)
        return x + xdot * dt

    return Plant(name="pendulum", state_dim=2, control_dim=1, dt=dt, step=step)


def pendulum_cost() -> QuadraticCost:
    return QuadraticCost(q_diag=torch.tensor([10.0, 0.1]), r=torch.tensor(0.01),
                         p_diag=torch.tensor([100.0, 1.0]))


def double_integrator(dt: float = 0.05) -> Plant:
    """1-D double integrator, state (pos, vel): x' = A_d x + B_d u with A_d =
    [[1, dt], [0, 1]] and B_d = [dt^2 / 2, dt], rounded to float32, each row
    summed left to right as the JAX package's full-precision matmuls
    (``utils/precision.hmatmul``) give it."""
    a = [[1.0, float(torch.tensor(dt, dtype=torch.float32))], [0.0, 1.0]]
    b = [float(torch.tensor(0.5 * dt * dt, dtype=torch.float32)),
         float(torch.tensor(dt, dtype=torch.float32))]

    def step(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        uu = u[..., 0]
        rows = [ai[0] * x[..., 0] + ai[1] * x[..., 1] + bi * uu for ai, bi in zip(a, b)]
        return torch.stack(rows, dim=-1)

    return Plant(name="double_integrator", state_dim=2, control_dim=1, dt=dt, step=step)


def double_integrator_cost() -> QuadraticCost:
    return QuadraticCost(q_diag=torch.tensor([1.0, 0.1]), r=torch.tensor(0.1),
                         p_diag=torch.tensor([10.0, 1.0]))
