"""The 12-state quadrotor of ``mpc_via_diffusion_model_tpu/dynamics/quadrotor.py``,
fp32, each step and cost taking leading batch axes (x (..., 12), u (..., 4)):

- ``quadrotor``: state (p[3], v[3], rpy[3], omega[3]), controls (total
  thrust, body torques), the small-angle rigid-body model, Euler forward at
  dt = 0.02, in the JAX step's order of operations (ZYX body-z,
  ``tth = sth / max(cth, 1e-3)``, the explicit cross product,
  ``omega_dot = (tau - gyro) / inertia``), with ``quadrotor_cost``;
- ``obstacle_cost`` (a position trajectory against spheres) and
  ``obstacle_cost_single`` (one state, sphere by sphere);
- ``SafetyFirstCost``: the best-of-K selection cost of the quadrotor task
  (``scripts/quadrotor_task.py::make_select_cost`` builds it), in an order
  of operations fixed term by term, so that the episode kernel's scorer
  (``ops/csrc/plants.cuh``, ``SafetyFirstScorer``) computes the same sums.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .base import Plant, QuadraticCost

__all__ = ["quadrotor", "quadrotor_cost", "obstacle_cost", "obstacle_cost_single",
           "SafetyFirstCost"]

_G = 9.81


def _on(consts: dict, device) -> tuple:
    """The tensors of ``consts["cpu"]`` on ``device``, copied there once: a
    step runs many times, and a copy per call would cost a transfer each."""
    key = str(device)
    if key not in consts:
        consts[key] = tuple(t.to(device) for t in consts["cpu"])
    return consts[key]


def quadrotor(dt: float = 0.02, m: float = 1.0, ixx: float = 0.01, iyy: float = 0.01,
              izz: float = 0.02) -> Plant:
    """``device_consts`` are m and the inertia (ixx, iyy, izz) in float32,
    which the episode kernel's device function reads after dt."""
    consts = {"cpu": (torch.tensor([ixx, iyy, izz], dtype=torch.float32),
                      torch.tensor([0.0, 0.0, _G], dtype=torch.float32))}
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))

    def step(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        inr, gravity = _on(consts, x.device)
        v, omega = x[..., 3:6], x[..., 9:12]
        thrust, tau = u[..., 0], u[..., 1:4]
        # cos and sin of (phi, theta, psi), each element as alone
        (cphi, cth, cpsi), (sphi, sth, spsi) = (torch.cos(x[..., 6:9]).unbind(-1),
                                                torch.sin(x[..., 6:9]).unbind(-1))
        # body-z in world frame (ZYX Euler)
        z_body = torch.stack([cpsi * sth * cphi + spsi * sphi, spsi * sth * cphi - cpsi * sphi,
                              cth * cphi], dim=-1)
        acc = z_body * (thrust / m)[..., None] - gravity
        # Euler-angle kinematics (small-attitude-safe form)
        cth_safe = torch.clamp_min(cth, 1e-3)
        tth = sth / cth_safe
        om0, om1, om2 = omega[..., 0], omega[..., 1], omega[..., 2]
        rpy_dot = torch.stack([om0 + sphi * tth * om1 + cphi * tth * om2,
                               cphi * om1 - sphi * om2,
                               (sphi * om1 + cphi * om2) / cth_safe], dim=-1)
        iw = inr * omega
        gyro = torch.stack([om1 * iw[..., 2] - om2 * iw[..., 1],
                            om2 * iw[..., 0] - om0 * iw[..., 2],
                            om0 * iw[..., 1] - om1 * iw[..., 0]], dim=-1)
        omega_dot = (tau - gyro) / inr
        xdot = torch.cat([v, acc, rpy_dot, omega_dot], dim=-1)
        return x + xdot * dt

    return Plant(name="quadrotor", state_dim=12, control_dim=4, dt=dt, step=step,
                 device_consts=(f32(m), f32(ixx), f32(iyy), f32(izz)))


def quadrotor_cost() -> QuadraticCost:
    return QuadraticCost(
        q_diag=torch.tensor([10.0, 10.0, 10.0, 1.0, 1.0, 1.0, 5.0, 5.0, 5.0, 0.1, 0.1, 0.1],
                            dtype=torch.float32),
        r=torch.tensor([0.1, 0.5, 0.5, 0.5], dtype=torch.float32),
        p_diag=torch.tensor([100.0, 100.0, 100.0, 10.0, 10.0, 10.0, 10.0, 10.0, 10.0, 1.0, 1.0,
                             1.0], dtype=torch.float32),
    )


def obstacle_cost(states: torch.Tensor, centers: torch.Tensor, radii: torch.Tensor,
                  weight: float = 100.0) -> torch.Tensor:
    """Soft sphere-obstacle penalty over a position trajectory: states (...,
    H, d) with positions in dims 0:3, centers (n_obs, 3) and radii (n_obs,)
    shared by every trajectory, or one scene per trajectory, centers (...,
    n_obs, 3) and radii (..., n_obs) -> (...), the hinge on each (state,
    obstacle) penetration depth squared, summed over H and the obstacles,
    times ``weight``."""
    pos = states[..., 0:3][..., None, :]  # (..., H, 1, 3)
    d = torch.sqrt(torch.sum(torch.square(pos - centers[..., None, :, :]), dim=-1))  # (..., H, n_obs)
    penetration = torch.clamp_min(radii[..., None, :] - d, 0.0)
    return weight * torch.sum(torch.square(penetration), dim=(-1, -2))


def _sum_last(t: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis left to right, one add per element, as the
    kernel's scorer adds (torch.sum may add in another order)."""
    acc = t[..., 0]
    for i in range(1, t.shape[-1]):
        acc = acc + t[..., i]
    return acc


def obstacle_cost_single(x: torch.Tensor, centers: torch.Tensor, radii: torch.Tensor,
                         weight: float = 100.0) -> torch.Tensor:
    """``obstacle_cost`` of one state x (..., d), per sphere j: d =
    sqrt(((p0 - c0)^2 + (p1 - c1)^2) + (p2 - c2)^2) and the hinge
    pen_j = max(r_j - d, 0), summed over the spheres in order as
    (weight * pen_j) * pen_j."""
    dp = x[..., None, 0:3] - centers                     # (..., n_obs, 3)
    d = torch.sqrt(_sum_last(dp * dp))
    pen = torch.clamp_min(radii - d, 0.0)
    return _sum_last(weight * pen * pen)


@dataclasses.dataclass(frozen=True)
class SafetyFirstCost:
    """The quadrotor task's candidate-selection cost (the JAX package's
    ``scripts/quadrotor_task.py::make_select_cost``): per stage
    ``quad.stage(x, 0 du) + factor * sum du^2 + hinge(x)`` with du = u -
    u_hover and the hinge ``obstacle_cost_single`` against ``radii`` (already
    inflated by the margin) at ``weight``; terminal ``quad.terminal(x) +
    hinge(x)``. Every sum runs left to right, term by term, as the episode
    kernel's ``SafetyFirstScorer`` adds.

    ``scorer`` names the episode kernels' device scorer that computes it and
    ``device_consts`` the float32 numbers that scorer reads after the
    plant's: u_hover, factor, weight, the centers row-major, the radii."""

    quad: QuadraticCost
    u_hover: torch.Tensor
    centers: torch.Tensor
    radii: torch.Tensor
    weight: float
    factor: float = 0.05
    scorer = "safety_first"

    @property
    def q_diag(self) -> torch.Tensor:
        return self.quad.q_diag

    @property
    def r(self) -> torch.Tensor:
        return self.quad.r

    @property
    def p_diag(self) -> torch.Tensor:
        return self.quad.p_diag

    @property
    def device_consts(self) -> Tuple[float, ...]:
        f32 = lambda t: [float(v) for v in t.detach().to(torch.float32).cpu().reshape(-1)]
        return tuple(f32(self.u_hover) + f32(torch.tensor([self.factor, self.weight]))
                     + f32(self.centers) + f32(self.radii))

    def to(self, device) -> "SafetyFirstCost":
        return dataclasses.replace(self, quad=self.quad.to(device),
                                   u_hover=self.u_hover.to(device),
                                   centers=self.centers.to(device), radii=self.radii.to(device))

    def _quad_stage(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return (_sum_last(self.quad.q_diag * (x * x))
                + _sum_last(self.quad.r.expand(u.shape[-1]) * (u * u)))

    def _hinge(self, x: torch.Tensor) -> torch.Tensor:
        return obstacle_cost_single(x, self.centers, self.radii, self.weight)

    def stage(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        du = u - self.u_hover
        return (self._quad_stage(x, du * 0.0) + self.factor * _sum_last(du * du)
                + self._hinge(x))

    def terminal(self, x: torch.Tensor) -> torch.Tensor:
        return _sum_last(self.quad.p_diag * (x * x)) + self._hinge(x)
