"""Finite-horizon LQR by the backward Riccati recursion: port of
``mpc_via_diffusion_model_tpu/solvers/lqr.py`` (``LQRSolution``,
``lqr_gains``, ``lqr_solve``, ``lqr_solve_batched``).

The LMPC problem has only the dynamics as constraints and a quadratic
objective, so the Riccati solution is its optimum:
J = sum_{k<N} (x_k'Q x_k + u_k'R u_k) + x_N'P x_N. Float32 tensors on the
device of ``x0``; ``x0`` may carry leading batch axes, which stand in for the
JAX package's ``vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["LQRSolution", "lqr_gains", "lqr_solve", "lqr_solve_batched"]


@dataclasses.dataclass(frozen=True)
class LQRSolution:
    us: torch.Tensor    # (..., H, m)
    xs: torch.Tensor    # (..., H + 1, n)
    cost: torch.Tensor  # (...)


def lqr_gains(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
              p: torch.Tensor, horizon: int) -> torch.Tensor:
    """Backward Riccati recursion; the time-varying gains K (H, m, n) with
    u_k = -K_k x_k, the value matrix symmetrised at every step."""
    v, ks = p, []
    for _ in range(horizon):
        btv = b.T @ v
        k_gain = torch.linalg.solve(r + btv @ b, btv @ a)
        a_cl = a - b @ k_gain
        v = q + k_gain.T @ (r @ k_gain) + a_cl.T @ (v @ a_cl)
        v = 0.5 * (v + v.T)
        ks.append(k_gain)
    return torch.stack(ks[::-1])


def lqr_solve(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
              p: torch.Tensor, x0: torch.Tensor, horizon: int,
              gains: Optional[torch.Tensor] = None) -> LQRSolution:
    """The open-loop optimal controls, states and cost from ``x0`` (..., n).
    Pass ``gains`` (``lqr_gains``) to skip the state-independent recursion
    in a receding-horizon loop."""
    ks = lqr_gains(a, b, q, r, p, horizon) if gains is None else gains
    quad = lambda m, v: torch.sum(v * (v @ m.T), dim=-1)  # v'Mv over the last axis
    x, us, xs = x0, [], [x0]
    cost = torch.zeros(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    for k_gain in ks:
        u = -(x @ k_gain.T)
        cost = cost + quad(q, x) + quad(r, u)
        x = x @ a.T + u @ b.T
        us.append(u)
        xs.append(x)
    return LQRSolution(us=torch.stack(us, dim=-2), xs=torch.stack(xs, dim=-2),
                       cost=cost + quad(p, x))


def lqr_solve_batched(a, b, q, r, p, x0_batch: torch.Tensor, horizon: int) -> LQRSolution:
    """``lqr_solve`` over a batch of initial states (N, n), the gains
    computed once and shared."""
    return lqr_solve(a, b, q, r, p, x0_batch, horizon)
