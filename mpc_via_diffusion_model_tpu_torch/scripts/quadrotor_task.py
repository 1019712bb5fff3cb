"""The quadrotor flagship task: a copy of the JAX package's top-level
``scripts/quadrotor_task.py`` (the obstacle scene, the hover thrust, the task
and selection costs in torch, the obstacle-clearance guide and its loop
builder through torch autograd, the held-out eval starts, the random scenes
of the scene-conditioned study and the metrics in numpy, the scene's
condition features and the clearance in torch), which the port does not
import.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..data.normalization import NormalizerStats, normalize, unnormalize
from ..dynamics.base import Plant, QuadraticCost, rollout
from ..dynamics.quadrotor import SafetyFirstCost, obstacle_cost
from ..solvers.lqr import lqr_gains

__all__ = ["OBS_CENTERS", "OBS_RADII", "HOVER_THRUST", "make_task_cost", "make_select_cost",
           "make_penalty_grad", "rows_of", "make_loop_guide_builder", "make_lqr_hover_plan",
           "sample_scenes",
           "scene_features",
           "eval_start_states", "min_clearance", "min_clearance_torch", "track_metrics"]

OBS_CENTERS = np.array([[1.5, 0.0, 1.0], [0.9, 0.9, 1.2], [0.9, -0.9, 0.8]], np.float32)
OBS_RADII = np.array([0.45, 0.40, 0.40], np.float32)

HOVER_THRUST = 9.81  # thrust for m=1 hover


def _u_hover() -> torch.Tensor:
    return torch.tensor([HOVER_THRUST, 0.0, 0.0, 0.0], dtype=torch.float32)


def make_task_cost(quad_cost: QuadraticCost):
    """Hover-at-origin quadratic + soft obstacle penalty: ``stage(x, u)``
    and ``terminal(x)`` on leading batch axes."""
    centers, radii = torch.from_numpy(OBS_CENTERS), torch.from_numpy(OBS_RADII)
    u_hover = _u_hover()

    class TaskCost:
        @staticmethod
        def stage(x, u):
            du = u - u_hover.to(u.device)
            # obstacle_cost sums over (H, n_obs); x[..., None, :] is H = 1
            return (quad_cost.stage(x, du * 0.0) + 0.05 * torch.sum(torch.square(du), dim=-1)
                    + obstacle_cost(x[..., None, :], centers.to(x.device), radii.to(x.device)))

        @staticmethod
        def terminal(x):
            return quad_cost.terminal(x) + obstacle_cost(x[..., None, :], centers.to(x.device),
                                                         radii.to(x.device))

        @staticmethod
        def to(device):
            """The same cost with the quadratic on ``device`` (the obstacle
            terms move their constants to the state's device)."""
            return make_task_cost(quad_cost.to(device))

    return TaskCost()


def make_select_cost(quad_cost: QuadraticCost, margin: float = 0.15, weight: float = 2e5,
                     centers=None, radii=None) -> SafetyFirstCost:
    """The candidate-selection cost for best-of-K replanning: the obstacle
    hinge against radii inflated by ``margin`` at a heavy ``weight``
    (near-lexicographic safety first), plus the hover quadratic. Returns a
    ``SafetyFirstCost``, whose ``stage`` and ``terminal`` score candidates in
    the per-replan loop and which the episode kernel lays out as its
    scorer's constants."""
    c = torch.as_tensor(OBS_CENTERS if centers is None else centers, dtype=torch.float32)
    r = torch.as_tensor(OBS_RADII if radii is None else radii, dtype=torch.float32) + margin
    return SafetyFirstCost(quad=quad_cost, u_hover=_u_hover(), centers=c, radii=r,
                           weight=float(weight))


def make_penalty_grad(plant: Plant, in_stats: NormalizerStats, guide_scale: float,
                      scene_args: bool = False) -> Callable:
    """The guided-descent step ``per(u_norm (B, H, 4), x0) -> (B, H, 4)``:
    each normalized plan is unnormalized and rolled out from its state (x0
    (12,) shared, or (B, 12) one per plan; the states include x0), its
    obstacle penalty (``obstacle_cost``) is differentiated with respect to
    u_norm, non-finite entries of the gradient are set to 0 (a partly
    denoised plan can blow the rollout up, and clamp(NaN) is NaN), and the
    step is ``-guide_scale * clamp(g, -1, 1)``.

    The plans are independent, so one ``torch.autograd.grad`` of the
    batch's summed penalty is the JAX package's per-plan ``jax.grad`` under
    ``vmap``. Autograd runs on a detached leaf copy of u_norm under
    ``torch.enable_grad()`` (the loops run under ``no_grad``), and the step
    comes back detached. With ``scene_args`` the step takes the scene too,
    ``per(u_norm, x0, centers (B, 3, 3), radii (B, 3))``, one per plan;
    else the canonical scene."""
    consts = {}

    def on(device):
        """The statistics and the canonical scene on ``device``, copied there once."""
        key = str(device)
        if key not in consts:
            consts[key] = (in_stats.to(device), torch.from_numpy(OBS_CENTERS).to(device),
                           torch.from_numpy(OBS_RADII).to(device))
        return consts[key]

    def per_scene(u_norm, x0, centers, radii):
        with torch.enable_grad():
            un = u_norm.detach().clone().requires_grad_(True)
            states = rollout(plant, x0.expand(un.shape[0], x0.shape[-1]),
                             unnormalize(on(un.device)[0], un))
            (g,) = torch.autograd.grad(obstacle_cost(states, centers, radii).sum(), un)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        return -guide_scale * torch.clamp(g, -1.0, 1.0)

    if scene_args:
        return per_scene
    return lambda u_norm, x0: per_scene(u_norm, x0, *on(u_norm.device)[1:])


def rows_of(x0: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Each of ``n_rows`` sampler rows' own x0: a single state (n,) as it
    is, or a batch (N, ...) (states, or per-row scenes) with each entry
    repeated for its n_rows / N candidates (row j belongs to entry j // K,
    as the batched loop lays them out)."""
    return x0 if x0.dim() == 1 else x0.repeat_interleave(n_rows // x0.shape[0], dim=0)


def make_loop_guide_builder(plant: Plant, in_stats: NormalizerStats,
                            guide_scale: float) -> Callable:
    """``guide_builder(x0)`` for ``control.make_closed_loop``: each replan's
    guide on the canonical scene, every candidate row from its own state
    (the loop's state, or its batch of states)."""
    per = make_penalty_grad(plant, in_stats, guide_scale)

    def guide_builder(x0):
        return lambda u_norm: per(u_norm, rows_of(x0, u_norm.shape[0]))

    return guide_builder


def make_lqr_hover_plan(plant: Plant, quad_cost: QuadraticCost, in_stats: NormalizerStats,
                        horizon: int, device="cpu") -> Callable:
    """The hover regulator's plan ``x0 (..., 12) -> u_norm (..., horizon,
    4)``: the plant linearized at hover (x = 0, u = [m g, 0, 0, 0]) by
    ``torch.func.jacfwd``, the backward Riccati gains on the task's own Q, R
    and P (``solvers.lqr.lqr_gains``), then the NONLINEAR plant rolled
    closed-loop with ``u_t = u_hover - K_t x_t`` in float32, and the controls
    normalized and clipped to [-1, 1]. The best-of-K labeler appends it to
    its candidates: near the goal it holds position, which no sampled plan
    does; far away it loses the scoring to them."""
    dev = torch.device(device)
    u_hover = _u_hover().to(dev)
    x_eq = torch.zeros(plant.state_dim, dtype=torch.float32, device=dev)
    a = torch.func.jacfwd(lambda x: plant.step(x, u_hover))(x_eq).float()
    b = torch.func.jacfwd(lambda u: plant.step(x_eq, u))(u_hover).float()
    cost = quad_cost.to(dev)
    r_mat = (torch.diag(cost.r) if cost.r.dim() == 1
             else cost.r * torch.eye(plant.control_dim, device=dev))
    ks = lqr_gains(a, b, torch.diag(cost.q_diag), r_mat, torch.diag(cost.p_diag), horizon)
    stats = in_stats.to(dev)

    def plan(x0: torch.Tensor) -> torch.Tensor:
        x, us = x0, []
        for k_gain in ks:
            u = u_hover - x @ k_gain.T
            x = plant.step(x, u)
            us.append(u)
        return torch.clamp(normalize(stats, torch.stack(us, dim=-2)), -1.0, 1.0)

    return plan


def sample_scenes(n: int, seed: int = 0):
    """Random 3-sphere scenes of the scene-conditioned study: perturbations
    of the canonical layout with the start box (x >= 2.2) and the goal (the
    origin) kept clear. Returns ``(centers (n, 3, 3), radii (n, 3))``,
    float32, the draws of the JAX task's ``RandomState(seed)`` in its order.
    The canonical scene is in-support (zero perturbation)."""
    rng = np.random.RandomState(seed)
    centers = (OBS_CENTERS[None] + np.stack([
        rng.uniform(-0.3, 0.3, (n, 3)),
        rng.uniform(-0.3, 0.3, (n, 3)),
        rng.uniform(-0.2, 0.2, (n, 3)),
    ], axis=-1)).astype(np.float32)
    radii = (OBS_RADII[None] * rng.uniform(0.8, 1.15, (n, 3))).astype(np.float32)
    # keep the start box clear: sphere extent along +x stays below 2.1
    centers[..., 0] = np.minimum(centers[..., 0], 2.1 - radii)
    # keep the goal (origin) clear: push centers out to norm >= radius + 0.3
    norms = np.linalg.norm(centers, axis=-1, keepdims=True)
    min_norm = (radii + 0.3)[..., None]
    scale = np.maximum(min_norm / np.maximum(norms, 1e-6), 1.0)
    centers *= scale
    return centers, radii


def scene_features(centers, radii) -> torch.Tensor:
    """A scene (or a batch of scenes) flattened to the 12-dim block of
    condition features: ``[centers.ravel() (9), radii (3)]``, float32."""
    c = torch.as_tensor(centers, dtype=torch.float32)
    r = torch.as_tensor(radii, dtype=torch.float32)
    lead = c.shape[:-2]
    return torch.cat([c.reshape(*lead, 9), r.reshape(*lead, 3)], dim=-1)


def eval_start_states(n: int, seed: int = 7) -> np.ndarray:
    """The held-out eval-start distribution (x in [2.2, 3], y in [-1.2, 1.2],
    z in [0.6, 1.4], rest zero), (n, 12) float32."""
    rng = np.random.RandomState(seed)
    ev = np.zeros((n, 12), np.float32)
    ev[:, 0] = rng.uniform(2.2, 3.0, n)
    ev[:, 1] = rng.uniform(-1.2, 1.2, n)
    ev[:, 2] = rng.uniform(0.6, 1.4, n)
    return ev


def min_clearance(xt, centers=None, radii=None) -> np.ndarray:
    """Min obstacle clearance per track: ``(..., T, 12) -> (...,)``
    (negative = collision). Canonical scene unless centers/radii given."""
    xt = np.asarray(xt)
    c = OBS_CENTERS if centers is None else np.asarray(centers)
    r = OBS_RADII if radii is None else np.asarray(radii)
    d = np.linalg.norm(xt[..., :, None, 0:3] - c, axis=-1)
    return (d - r).min(axis=(-1, -2))


def min_clearance_torch(states: torch.Tensor, centers=None, radii=None) -> torch.Tensor:
    """The torch twin of :func:`min_clearance` (the JAX task's
    ``min_clearance_jax``): ``states (..., T, >=3) -> (...)``, the canonical
    scene unless centers (n_obs, 3) and radii (n_obs,) are given, or one
    scene per track, (..., n_obs, 3) and (..., n_obs)."""
    c = torch.as_tensor(OBS_CENTERS if centers is None else centers, dtype=torch.float32,
                        device=states.device)
    r = torch.as_tensor(OBS_RADII if radii is None else radii, dtype=torch.float32,
                        device=states.device)
    d = torch.linalg.norm(states[..., :, None, 0:3] - c[..., None, :, :], dim=-1)
    return (d - r[..., None, :]).amin(dim=(-1, -2))


def track_metrics(xt, stage_costs=None, centers=None, radii=None) -> dict:
    """The flagship eval metrics for a batch of closed-loop tracks
    ``(N, T, 12)``: collision-free / goal-reach / safe-reach fractions, mean
    min-clearance and goal distance (+ cost when stage_costs given); a
    diverged track counts against the fractions and stays out of the means."""
    xt = np.asarray(xt)
    if centers is not None and np.asarray(centers).ndim == 3:
        clearance = np.stack([min_clearance(xt[i], centers[i], radii[i])
                              for i in range(xt.shape[0])])
    else:
        clearance = min_clearance(xt, centers, radii)
    goal_dist = np.linalg.norm(xt[:, -1, 0:3], axis=-1)
    fin = np.isfinite(clearance) & np.isfinite(goal_dist)
    cf, rf = clearance > 0, goal_dist < 0.5
    out = {
        "collision_free_fraction": float(cf.mean()),
        "min_clearance_mean": float(clearance[fin].mean()) if fin.any() else None,
        "goal_dist_mean": float(goal_dist[fin].mean()) if fin.any() else None,
        "goal_reach_fraction_0.5": float(rf.mean()),
        "safe_reach_fraction": float((cf & rf).mean()),
    }
    if (~fin).any():
        out["diverged_fraction"] = float((~fin).mean())
    if stage_costs is not None:
        out["cost_mean"] = float(np.asarray(stage_costs).sum(axis=1).mean())
    return out
