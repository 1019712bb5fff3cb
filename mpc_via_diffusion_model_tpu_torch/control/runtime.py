"""Receding-horizon diffusion-MPC loop: port of ``make_replan_fn`` and
``make_closed_loop`` of ``mpc_via_diffusion_model_tpu/control/runtime.py``
for one candidate per replan (K = 1).

Each replan normalizes the plant state, samples one control horizon with
the CFG DDPM chain, unnormalizes it and applies its first control. The JAX
loop splits one key per replan; here each replan takes its own slice of
staged noise (n_steps, n_total + 1, 1, H, du), or draws it from a
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..data.normalization import NormalizerStats, normalize, unnormalize
from ..diffusion.gaussian_diffusion import GaussianDiffusion
from ..dynamics.base import Plant, QuadraticCost
from ..models.temporal_unet import TemporalUnet
from ..utils.device import resolve_device

__all__ = ["ClosedLoopResult", "make_replan_fn", "make_closed_loop"]

SampleFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ClosedLoopResult:
    x_track: torch.Tensor      # (n_steps + 1, state_dim)
    u_track: torch.Tensor      # (n_steps, control_dim)
    u_horizons: torch.Tensor   # (n_steps, horizon, control_dim) sampled plans
    stage_costs: torch.Tensor  # (n_steps,)


def make_replan_fn(diffusion: GaussianDiffusion, model: TemporalUnet,
                   inputs_stats: NormalizerStats, condition_stats: NormalizerStats,
                   horizon: int, control_dim: int = 1, w: float = 0.01,
                   n_diffusion_steps_without_noise: int = 5,
                   sample_override: Optional[SampleFn] = None):
    """``replan(x0, noise) -> (u_horizon (H, du), u_candidates (1, H, du))``.

    ``sample_override(context_norm (1, dx), noise) -> u_norm (1, H, du)``
    replaces ``ddpm_cfg_sample``, e.g. a ``FusedCfgChain``."""
    denoise = lambda x, t, c, m: model(x, t, c, m)

    def replan(x0: torch.Tensor, noise: torch.Tensor):
        ctx = normalize(condition_stats, x0)[None, :]
        if sample_override is not None:
            u_norm = sample_override(ctx, noise)
        else:
            u_norm = diffusion.ddpm_cfg_sample(
                denoise, (1, horizon, control_dim), ctx, w=w,
                n_diffusion_steps_without_noise=n_diffusion_steps_without_noise, noise=noise)
        u_cand = unnormalize(inputs_stats, u_norm)
        return u_cand[0], u_cand

    return replan


def make_closed_loop(diffusion: GaussianDiffusion, model: TemporalUnet,
                     inputs_stats: NormalizerStats, condition_stats: NormalizerStats,
                     plant: Plant, cost: QuadraticCost, horizon: int, n_steps: int = 80,
                     w: float = 0.01, n_diffusion_steps_without_noise: int = 5,
                     sample_override: Optional[SampleFn] = None, device=None):
    """``closed_loop(x0, noise=None, generator=None) -> ClosedLoopResult`` on
    ``device`` (``cuda`` unless given). ``noise`` is (n_steps, n_total + 1,
    1, horizon, control_dim); without it each replan's noise is drawn from
    ``generator``. Defaults are the flagship run's: 80 replans, T = 25 + 5,
    w = 0.01."""
    dev = resolve_device(device)
    inputs_stats, condition_stats = inputs_stats.to(dev), condition_stats.to(dev)
    cost = cost.to(dev)
    replan = make_replan_fn(diffusion, model, inputs_stats, condition_stats, horizon,
                            plant.control_dim, w, n_diffusion_steps_without_noise,
                            sample_override)
    n_total = diffusion.schedule.n_steps + n_diffusion_steps_without_noise
    noise_shape = (n_steps, n_total + 1, 1, horizon, plant.control_dim)

    @torch.no_grad()
    def closed_loop(x0: torch.Tensor, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> ClosedLoopResult:
        if noise is None:
            noise = torch.randn(noise_shape, generator=generator, dtype=torch.float32, device=dev)
        elif tuple(noise.shape) != noise_shape:
            raise ValueError(f"noise must be {noise_shape}, got {tuple(noise.shape)}")
        x = x0.to(device=dev, dtype=torch.float32)
        noise = noise.to(dev)
        xs, us, u_hors, stages = [x], [], [], []
        for k in range(n_steps):
            u_hor, _ = replan(x, noise[k])
            u0 = u_hor[0]
            stages.append(cost.stage(x, u0))
            x = plant.step(x, u0)
            xs.append(x)
            us.append(u0)
            u_hors.append(u_hor)
        return ClosedLoopResult(x_track=torch.stack(xs), u_track=torch.stack(us),
                                u_horizons=torch.stack(u_hors), stage_costs=torch.stack(stages))

    return closed_loop
