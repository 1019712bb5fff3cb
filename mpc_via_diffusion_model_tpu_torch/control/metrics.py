"""Parity and cost metrics of closed-loop runs: port of
``mpc_via_diffusion_model_tpu/control/metrics.py``.

- ``track_parity``: L1 state and input track differences against the expert
  (the reference's ``Diffusion_MPC_Inference.py:483-497``);
- ``per_step_mpc_costs``: the reference-convention cost of each replan's
  applied horizon (``dynamics.reference_mpc_cost``);
- ``count_swing_modes``: runs ending left or right of upright.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..dynamics.base import Plant, QuadraticCost, reference_mpc_cost
from .runtime import ClosedLoopResult

__all__ = ["track_parity", "per_step_mpc_costs", "count_swing_modes"]


def track_parity(result, expert) -> Dict[str, float]:
    """L1 differences between two closed-loop runs, per state dimension and
    for the input, over their common length. Each run is anything with
    ``x_track`` (n + 1, d) and ``u_track`` (n, m), a ``ClosedLoopResult`` or
    an expert's stored numpy tracks; compared in float32 on the CPU."""
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).cpu()
    n = min(result.u_track.shape[0], expert.u_track.shape[0])
    x_diff = torch.abs(f32(result.x_track)[:n + 1] - f32(expert.x_track)[:n + 1])
    u_diff = torch.abs(f32(result.u_track)[:n] - f32(expert.u_track)[:n])
    out = {f"x{i}_l1": float(torch.sum(x_diff[:, i])) for i in range(x_diff.shape[1])}
    out["u_l1"] = float(torch.sum(u_diff))
    out["u_l1_max"] = float(torch.max(u_diff))
    return out


def per_step_mpc_costs(plant: Plant, cost: QuadraticCost, result: ClosedLoopResult) -> torch.Tensor:
    """(n_steps,) reference-convention MPC cost of each step's applied
    horizon from the state it was planned at."""
    return reference_mpc_cost(plant, cost, result.x_track[:-1], result.u_horizons)


def count_swing_modes(theta_tracks, theta_idx: int = 2) -> Dict[str, int]:
    """Runs ending left (theta < pi) and right (theta >= pi) of upright.
    ``theta_tracks`` is (n_runs, n_steps + 1, state_dim) or (n_runs, n_steps + 1)."""
    arr = np.asarray(theta_tracks.cpu() if isinstance(theta_tracks, torch.Tensor) else theta_tracks)
    finals = arr[:, -1, theta_idx] if arr.ndim == 3 else arr[:, -1]
    return {"left": int(np.sum(finals < np.pi)), "right": int(np.sum(finals >= np.pi))}
