"""Expert dataset generation on the device: port of
``mpc_via_diffusion_model_tpu/data/generation.py`` (``make_initial_state_grid``,
``collect_lmpc_dataset``, ``collect_closed_loop_dataset``).

- ``collect_lmpc_dataset``: the open-loop LQR expert over a grid of initial
  states and, optionally, Gaussian noisy replicas of every grid state,
  solved in one batched pass.
- ``collect_closed_loop_dataset``: the receding-horizon iLQR expert from
  every (grid state, initial-guess kick) group, with noisy replicas of the
  state solved at every control step. The groups and the replicas are one
  batch axis of one ``ilqr_solve`` per control step; the control steps are a
  Python loop that carries the shifted warm start.

Both return a ``ControlSequenceDataset`` (``u`` (N, H, du), ``x0`` (N, dx)).
``make_acrobot_grid`` waits for the acrobot (ROADMAP.md A5).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..dynamics.base import Plant, QuadraticCost
from ..solvers.ilqr import ILQRConfig, ilqr_solve
from ..solvers.lqr import lqr_solve_batched
from ..utils.device import resolve_device
from .datasets import ControlSequenceDataset

__all__ = ["collect_closed_loop_dataset", "collect_lmpc_dataset", "make_initial_state_grid"]


def make_initial_state_grid(pos_range, theta_range, state_dim: int = 4,
                            theta_to_virtual: Optional[Callable] = None) -> np.ndarray:
    """(pos x theta) grid of initial states (N, state_dim) float32, zeros
    elsewhere, position-major; with ``theta_to_virtual`` and five or more
    states, state 4 is the virtual angle of theta."""
    out = []
    for p in np.asarray(pos_range):
        for t in np.asarray(theta_range):
            x0 = np.zeros(state_dim, dtype=np.float32)
            x0[0] = p
            x0[2] = t
            if theta_to_virtual is not None and state_dim >= 5:
                x0[4] = theta_to_virtual(t)
            out.append(x0)
    return np.stack(out)


def _staged(noise: Optional[torch.Tensor], shape: tuple, generator: Optional[torch.Generator],
            dev: torch.device) -> torch.Tensor:
    """Standard normals of ``shape`` on ``dev``: ``noise`` when given, else drawn from ``generator``."""
    if noise is None:
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise must be {tuple(shape)}, got {tuple(noise.shape)}")
    return noise.to(dev, torch.float32)


def collect_lmpc_dataset(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                         p: torch.Tensor, x0_grid, horizon: int, noise_std: float = 0.0,
                         n_noisy: int = 0, noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         normalizer: str = "LimitsNormalizer") -> ControlSequenceDataset:
    """The LQR expert's horizons from every state of ``x0_grid`` (N, n) and,
    with ``n_noisy`` > 0, from ``n_noisy`` replicas of the grid, each state
    plus ``noise_std`` times a standard normal draw: ``noise`` (n_noisy, N,
    n) when given (e.g. the JAX package's draws), else drawn from
    ``generator``. The replicas follow the grid, replica by replica, as in
    the JAX package. A ``ControlSequenceDataset`` on the device of ``a``,
    fitted by the ``normalizer`` kind."""
    dev = a.device
    x0s = torch.as_tensor(np.asarray(x0_grid, np.float32), device=dev)
    if n_noisy > 0:
        noisy = x0s[None] + _staged(noise, (n_noisy, *x0s.shape), generator, dev) * noise_std
        x0s = torch.cat([x0s, noisy.reshape(-1, x0s.shape[-1])])
    us = lqr_solve_batched(a, b, q, r, p, x0s, horizon).us
    return ControlSequenceDataset.from_arrays(us, x0s, normalizer, device=dev)


def collect_closed_loop_dataset(
        plant: Plant, cost: QuadraticCost, x0_grid, horizon: int = 64, n_control_steps: int = 80,
        solver_iterations: int = 30, u_kick_scales: Tuple[float, ...] = (5.0, -5.0),
        noise_std: float = 0.15, n_noisy: int = 20, noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None, normalizer: str = "LimitsNormalizer",
        return_arrays: bool = False, state_to_condition: Optional[Callable] = None,
        cold_start: bool = False, device=None):
    """Closed-loop expert data on ``device`` (``cuda`` unless given).

    For every (x0 in grid) x (kick in ``u_kick_scales``) group: ``n_control_steps``
    of receding-horizon iLQR (``solver_iterations`` iterations at
    ``horizon``), each solve warm-started from the group's shifted previous
    solution, the first guess the constant kick; at each step also
    ``n_noisy`` solves from Gaussian-perturbed copies of the current state,
    x + ``noise_std`` times a standard normal, from the same warm start.
    ``cold_start=True`` starts EVERY solve from the group's constant kick
    (the reference collector's protocol). The normals are ``noise`` (G, K,
    S, n_noisy, n) for G grid states, K kicks and S steps when given (e.g.
    the JAX package's draws), else drawn from ``generator``.

    Rows: the nominal solves, then the noisy ones; each group-major (grid,
    kick, step, replica), as the JAX package orders them. The conditions are
    ``state_to_condition`` of the states (identity by default; it takes
    leading batch axes). Prints the fraction of solves whose last backward
    pass was PD, drops rows with a non-finite control, condition or cost,
    and returns ``(u, x, J)`` on the device with ``return_arrays``, else a
    ``ControlSequenceDataset`` with ``solver_converged_fraction`` set.
    Total rows before the drop: G * K * S * (1 + n_noisy)."""
    dev = resolve_device(device)
    cost = cost.to(dev)
    cfg = ILQRConfig(horizon=horizon, n_iterations=solver_iterations)
    x0s = torch.as_tensor(np.asarray(x0_grid, np.float32), device=dev)
    n, m, n_grid, n_kick = plant.state_dim, plant.control_dim, x0s.shape[0], len(u_kick_scales)
    n_groups = n_grid * n_kick
    kicks = torch.tensor(u_kick_scales, dtype=torch.float32, device=dev)
    x = x0s.repeat_interleave(n_kick, dim=0)  # group g * K + k: grid state g, kick k
    u_ws0 = kicks.repeat(n_grid)[:, None, None].expand(n_groups, horizon, m)
    if n_noisy > 0:
        normals = _staged(noise, (n_grid, n_kick, n_control_steps, n_noisy, n), generator, dev)
        normals = normals.reshape(n_groups, n_control_steps, n_noisy, n)
    u_ws, nominal, noisy = u_ws0, [], []
    for s in range(n_control_steps):
        ws = u_ws0 if cold_start else u_ws
        if n_noisy > 0:
            x_noisy = x[:, None] + normals[:, s] * noise_std  # (groups, replicas, n)
            sol = ilqr_solve(plant, cost, torch.cat([x, x_noisy.reshape(-1, n)]),
                             torch.cat([ws, ws.repeat_interleave(n_noisy, dim=0)]), cfg)
            noisy.append((x_noisy, sol.us[n_groups:].reshape(n_groups, n_noisy, horizon, m),
                          sol.cost[n_groups:].reshape(n_groups, n_noisy),
                          sol.backward_ok[n_groups:].reshape(n_groups, n_noisy)))
        else:
            sol = ilqr_solve(plant, cost, x, ws, cfg)
        us = sol.us[:n_groups]
        nominal.append((x, us, sol.cost[:n_groups], sol.backward_ok[:n_groups]))
        x = plant.step(x, us[:, 0])
        u_ws = torch.cat([us[:, 1:], us[:, -1:]], dim=1)

    to_cond = state_to_condition or (lambda v: v)
    parts = [nominal] + ([noisy] if n_noisy > 0 else [])
    # stacked over the steps at axis 1: (groups, steps, ...) then flattened group-major
    cat = lambda i, tail: torch.cat([torch.stack([rec[i] for rec in part], dim=1).reshape(-1, *tail)
                                     for part in parts])
    x_cat = to_cond(cat(0, (n,)))
    u_cat, j_cat, ok_cat = cat(1, (horizon, m)), cat(2, ()), cat(3, ())
    converged_fraction = ok_cat.float().mean().item() if ok_cat.numel() else 1.0
    print(f"[collect_closed_loop_dataset] solver backward-PD converged fraction: "
          f"{converged_fraction:.4f}", flush=True)
    valid = (torch.isfinite(u_cat).flatten(1).all(dim=1) & torch.isfinite(x_cat).all(dim=1)
             & torch.isfinite(j_cat))
    n_dropped = int((~valid).sum())
    if n_dropped:
        print(f"[collect_closed_loop_dataset] dropped {n_dropped} non-finite solver results",
              flush=True)
        u_cat, x_cat, j_cat = u_cat[valid], x_cat[valid], j_cat[valid]
    if return_arrays:
        return u_cat, x_cat, j_cat
    ds = ControlSequenceDataset.from_arrays(u_cat, x_cat, normalizer, device=dev)
    return dataclasses.replace(ds, solver_converged_fraction=converged_fraction)
