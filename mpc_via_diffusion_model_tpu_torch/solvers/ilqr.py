"""Batched iLQR, the nonlinear expert: port of
``mpc_via_diffusion_model_tpu/solvers/ilqr.py`` (``ILQRConfig``,
``ILQRSolution``, ``pd_solve``, ``ilqr_backward``, ``ilqr_forward``,
``ilqr_solve``, ``ilqr_solve_batched``).

Every function takes leading batch axes where the JAX package uses ``vmap``:
``x0`` (..., n), controls (..., H, m), states (..., H + 1, n). Float32 on the
device of ``x0``, the matmuls in fp32 (TF32 off, ``utils/device.py``):

- linearization: the Jacobians of the plant step at every (solve, time)
  point by ``torch.func.vmap(torch.func.jacrev(...))``, reverse mode as
  JAX's ``jax.jacobian`` (forward mode returns float64 Jacobians from
  float32 inputs through ``sin``/``cos`` in this PyTorch);
- backward pass: the Riccati-like recursion over the horizon with
  Levenberg regularization and the Cholesky guard (``pd_solve``);
- forward pass: the fixed line-search grid as one more batch axis, every
  candidate rolled out at once;
- the accept test, the regularization schedule and the carried solution are
  ``torch.where`` selects, so an iteration never waits on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch.func import jacrev, vmap

from ..dynamics.base import Plant, QuadraticCost

__all__ = ["ILQRConfig", "ILQRSolution", "ilqr_backward", "ilqr_forward", "ilqr_solve",
           "ilqr_solve_batched", "pd_solve"]


def pd_solve(mat: torch.Tensor, rhs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solves ``mat @ x = rhs`` for symmetric ``mat`` (..., m, m) by Cholesky,
    ``rhs`` (..., m, k). Returns ``(x, ok)``, ``ok`` (...) true where every
    Cholesky pivot succeeded and the factor is finite (so a NaN input is
    rejected, as JAX's ``isfinite(chol)`` rejects it); where not, ``x`` is
    zeroed. Never waits on the host: ``cholesky_ex`` reports failure on the
    device, and the two triangular solves (LAPACK's ``potrs`` on the CPU,
    bit for bit) stand in for ``torch.cholesky_solve``, whose batched CUDA
    path synchronizes the stream once per call."""
    chol, info = torch.linalg.cholesky_ex(mat)
    ok = (info == 0) & torch.isfinite(chol).flatten(-2).all(dim=-1)
    sol = torch.linalg.solve_triangular(
        chol.mT, torch.linalg.solve_triangular(chol, rhs, upper=False), upper=True)
    return torch.where(ok[..., None, None], sol, torch.zeros_like(sol)), ok


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    horizon: int
    n_iterations: int = 50
    line_search_alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
    reg_init: float = 1e-6
    reg_increase: float = 10.0
    reg_decrease: float = 2.0
    reg_min: float = 1e-8
    reg_max: float = 1e8


@dataclasses.dataclass(frozen=True)
class ILQRSolution:
    us: torch.Tensor                  # (..., H, m)
    xs: torch.Tensor                  # (..., H + 1, n)
    cost: torch.Tensor                # (...)
    improved_last_iter: torch.Tensor  # (...) bool
    backward_ok: torch.Tensor         # (...) bool: the last backward pass had every Quu_reg PD


def _mv(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """``mat @ vec`` over the last axes: (..., a, b) by (..., b) -> (..., a)."""
    return (mat @ vec[..., None])[..., 0]


def _total_cost(plant: Plant, cost: QuadraticCost, x0: torch.Tensor,
                us: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total cost (...), states (..., H + 1, n)) of the open-loop rollout."""
    x, xs = x0, [x0]
    acc = torch.zeros(x0.shape[:-1], dtype=torch.float32, device=x0.device)
    for t in range(us.shape[-2]):
        acc = acc + cost.stage(x, us[..., t, :])
        x = plant.step(x, us[..., t, :])
        xs.append(x)
    return acc + cost.terminal(x), torch.stack(xs, dim=-2)


def _jacobians(plant: Plant, xs: torch.Tensor, us: torch.Tensor):
    """(fx (..., n, n), fu (..., n, m)) of ``plant.step`` at every point of
    ``xs`` (..., n), ``us`` (..., m), by reverse mode; float32 asserted."""
    lead = us.shape[:-1]
    flat_x, flat_u = xs.reshape(-1, xs.shape[-1]), us.reshape(-1, us.shape[-1])
    fx, fu = vmap(jacrev(plant.step, argnums=(0, 1)))(flat_x, flat_u)
    if fx.dtype != torch.float32 or fu.dtype != torch.float32:
        raise TypeError(f"the plant's Jacobians are {fx.dtype}, {fu.dtype}; want float32")
    return fx.reshape(*lead, *fx.shape[-2:]), fu.reshape(*lead, *fu.shape[-2:])


def ilqr_backward(plant: Plant, cost: QuadraticCost, xs: torch.Tensor, us: torch.Tensor,
                  reg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LQ-approximation backward pass from ``xs`` (..., H + 1, n), ``us``
    (..., H, m) at regularization ``reg`` (a float or (...)). Returns (k
    (..., H, m), K (..., H, m, n), ok (...)), the feedforward and feedback
    terms of delta-u* = k + K delta-x, and whether every regularized Quu was
    PD."""
    m = plant.control_dim
    dev = xs.device
    r_diag = torch.broadcast_to(torch.atleast_1d(cost.r), (m,))
    q2 = 2.0 * torch.diag(cost.q_diag)
    r2 = 2.0 * torch.diag(r_diag)
    reg_eye = torch.as_tensor(reg, dtype=torch.float32, device=dev)[..., None, None] * torch.eye(
        m, device=dev)
    fx, fu = _jacobians(plant, xs[..., :-1, :], us)
    cx = 2.0 * cost.q_diag * xs[..., :-1, :]
    cu = 2.0 * r_diag * us
    vx = 2.0 * cost.p_diag * xs[..., -1, :]
    vxx = torch.broadcast_to(2.0 * torch.diag(cost.p_diag), (*vx.shape, vx.shape[-1]))
    ok = torch.ones(xs.shape[:-2], dtype=torch.bool, device=dev)
    ks, kgains = [], []
    for t in reversed(range(us.shape[-2])):
        fx_t, fu_t = fx[..., t, :, :], fu[..., t, :, :]
        fx_tt, fu_tt = fx_t.mT, fu_t.mT
        vxx_fx = vxx @ fx_t
        qx = cx[..., t, :] + _mv(fx_tt, vx)
        qu = cu[..., t, :] + _mv(fu_tt, vx)
        qxx = q2 + fx_tt @ vxx_fx
        quu = r2 + fu_tt @ (vxx @ fu_t)
        qux = fu_tt @ vxx_fx
        sol, ok_t = pd_solve(quu + reg_eye, torch.cat([qu[..., None], qux], dim=-1))
        k_t, k_gain_t = -sol[..., 0], -sol[..., 1:]
        k_gain_tt, qux_t = k_gain_t.mT, qux.mT
        vx = qx + _mv(k_gain_tt, _mv(quu, k_t)) + _mv(k_gain_tt, qu) + _mv(qux_t, k_t)
        vxx = qxx + k_gain_tt @ (quu @ k_gain_t) + k_gain_tt @ qux + qux_t @ k_gain_t
        vxx = 0.5 * (vxx + vxx.mT)
        ok = ok & ok_t
        ks.append(k_t)
        kgains.append(k_gain_t)
    return torch.stack(ks[::-1], dim=-2), torch.stack(kgains[::-1], dim=-3), ok


def ilqr_forward(plant: Plant, cost: QuadraticCost, x0: torch.Tensor, xs_ref: torch.Tensor,
                 us_ref: torch.Tensor, ks: torch.Tensor, kgains: torch.Tensor, alpha):
    """Closed-loop forward rollout with step size ``alpha`` (a float, or a
    tensor whose shape broadcasts against the batch axes, e.g. (A, 1) for A
    step sizes over a batch of one axis). Returns (us_new (..., H, m), xs_new
    (..., H + 1, n), total cost (...)), the batch axes those of the
    broadcast."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x0.device)[..., None]
    x = torch.broadcast_to(x0, torch.broadcast_shapes(alpha.shape, x0.shape))
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x0.device)
    xs, us = [x], []
    for t in range(us_ref.shape[-2]):
        u = us_ref[..., t, :] + alpha * ks[..., t, :] + _mv(kgains[..., t, :, :],
                                                            x - xs_ref[..., t, :])
        acc = acc + cost.stage(x, u)
        x = plant.step(x, u)
        us.append(u)
        xs.append(x)
    return torch.stack(us, dim=-2), torch.stack(xs, dim=-2), acc + cost.terminal(x)


def _iteration(plant: Plant, cost: QuadraticCost, x0: torch.Tensor, alphas: torch.Tensor,
               config: ILQRConfig, us: torch.Tensor, xs: torch.Tensor, j: torch.Tensor,
               reg: torch.Tensor):
    """One iteration over a batch (B, ...): the backward pass, the forward
    pass at every step size ``alphas`` (A, 1), non-finite candidate costs set
    to +inf, the first least of them taken (as ``jnp.argmin``), and the
    controls, states, cost and regularization updated where the backward
    pass was PD and the cost fell. Returns (us, xs, j, reg, ok, improved)."""
    ks, kgains, ok = ilqr_backward(plant, cost, xs, us, reg)
    us_c, xs_c, j_c = ilqr_forward(plant, cost, x0, xs, us, ks, kgains, alphas)
    j_c = torch.where(torch.isfinite(j_c), j_c, torch.full_like(j_c, float("inf")))
    best = torch.argmin(j_c, dim=0)
    rows = torch.arange(len(best), device=best.device)
    j_best = j_c[best, rows]
    improved = ok & (j_best < j)
    return (torch.where(improved[:, None, None], us_c[best, rows], us),
            torch.where(improved[:, None, None], xs_c[best, rows], xs),
            torch.where(improved, j_best, j),
            torch.where(improved, torch.clamp(reg / config.reg_decrease, min=config.reg_min),
                        torch.clamp(reg * config.reg_increase, max=config.reg_max)),
            ok, improved)


def ilqr_solve(plant: Plant, cost: QuadraticCost, x0: torch.Tensor, u_init: torch.Tensor,
               config: ILQRConfig) -> ILQRSolution:
    """min_u sum stage(x, u) + terminal(x_H) subject to the plant, from the
    control sequences ``u_init`` (..., H, m) at the states ``x0`` (..., n),
    every solve of the batch on its own regularization, ``config.n_iterations``
    iterations (``_iteration``)."""
    dev = x0.device
    cost = cost.to(dev)
    batch = x0.shape[:-1]
    x0 = x0.to(torch.float32).reshape(-1, x0.shape[-1])
    us = torch.broadcast_to(u_init.to(device=dev, dtype=torch.float32),
                            (*batch, *u_init.shape[-2:])).reshape(-1, *u_init.shape[-2:])
    alphas = torch.tensor(config.line_search_alphas, dtype=torch.float32, device=dev)[:, None]
    j, xs = _total_cost(plant, cost, x0, us)
    reg = torch.full(j.shape, config.reg_init, dtype=torch.float32, device=dev)
    ok = improved = torch.ones(j.shape, dtype=torch.bool, device=dev)
    for _ in range(config.n_iterations):
        us, xs, j, reg, ok, improved = _iteration(plant, cost, x0, alphas, config, us, xs, j, reg)
    return ILQRSolution(us=us.reshape(*batch, *us.shape[1:]), xs=xs.reshape(*batch, *xs.shape[1:]),
                        cost=j.reshape(batch), improved_last_iter=improved.reshape(batch),
                        backward_ok=ok.reshape(batch))


def ilqr_solve_batched(plant: Plant, cost: QuadraticCost, x0_batch: torch.Tensor,
                       u_init_batch: torch.Tensor, config: ILQRConfig) -> ILQRSolution:
    """``ilqr_solve`` over a batch of initial states (B, n) and guesses (B, H, m)."""
    return ilqr_solve(plant, cost, x0_batch, u_init_batch, config)
