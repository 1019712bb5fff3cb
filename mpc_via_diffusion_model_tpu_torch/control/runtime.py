"""Receding-horizon diffusion-MPC loop: port of ``make_replan_fn`` and
``make_closed_loop`` of ``mpc_via_diffusion_model_tpu/control/runtime.py``
with the ``ddpm`` sampler, best-of-K candidates and ``selection_horizon``.

Each replan maps the plant state to the condition (``state_to_condition``,
identity by default), normalizes it, samples K control horizons with the
CFG DDPM chain or a ``sample_override``, unnormalizes them and, for K > 1,
applies the first control of the candidate whose rollout costs least. The
JAX loop splits one key per replan and hands it to the sampler; here each
replan takes its own slice of staged noise, or draws it from a
``torch.Generator``, in the sampler's per-replan layout: (n_total + 1, K, H,
du), ``ddpm_cfg_sample``'s, by default; the ``noise_shape`` the caller
names for its override, e.g. (K, H, du), the ``x_init`` of a distilled
student's DDIM chain.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..data.normalization import NormalizerStats, normalize, unnormalize
from ..diffusion.gaussian_diffusion import DenoiseFn, GaussianDiffusion
from ..dynamics.base import Plant, QuadraticCost
from ..utils.device import resolve_device

__all__ = ["ClosedLoopResult", "make_replan_fn", "make_closed_loop"]

SampleFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ClosedLoopResult:
    x_track: torch.Tensor      # (n_steps + 1, state_dim)
    u_track: torch.Tensor      # (n_steps, control_dim)
    u_horizons: torch.Tensor   # (n_steps, horizon, control_dim) applied plans
    stage_costs: torch.Tensor  # (n_steps,)


def make_replan_fn(diffusion: GaussianDiffusion, denoise: DenoiseFn,
                   inputs_stats: NormalizerStats, condition_stats: NormalizerStats,
                   horizon: int, control_dim: int = 1, w: float = 0.01,
                   n_diffusion_steps_without_noise: int = 5, n_candidates: int = 1,
                   plant: Optional[Plant] = None, cost: Optional[QuadraticCost] = None,
                   state_to_condition: Optional[Callable] = None,
                   sample_override: Optional[SampleFn] = None,
                   selection_horizon: Optional[int] = None):
    """``replan(x0, noise) -> (u_horizon (H, du), u_candidates (K, H, du))``.

    ``denoise(x, t, context, context_mask) -> eps`` is the denoiser: a
    ``TemporalUnet``, or a ``FusedUnet`` as ``bench.py``'s
    ``BENCH_FUSED=1`` passes it. ``sample_override(context_norm (K, dc),
    noise) -> u_norm (K, H, du)`` replaces ``ddpm_cfg_sample``, e.g. a
    ``FusedCfgChain``, or a distilled student's DDIM chain
    (``FusedDdimChain``, ``make_student_ddim_sampler``) whose noise is its
    x_init. For K > 1 candidates are scored by ``cost`` over
    their rollout from the plant state, truncated to ``selection_horizon``
    steps (terminal cost only when the whole plan is scored)."""
    k = int(n_candidates)
    if k > 1 and (plant is None or cost is None):
        raise ValueError("candidate selection needs plant and cost")
    to_cond = state_to_condition or (lambda x: x)
    sel_h = int(selection_horizon or horizon)
    if not 1 <= sel_h <= horizon:
        raise ValueError(f"selection_horizon must be in 1..{horizon}, got {selection_horizon}")

    def replan(x0: torch.Tensor, noise: torch.Tensor):
        cond_norm = normalize(condition_stats, to_cond(x0))[None, :]
        ctx = cond_norm.expand(k, cond_norm.shape[-1])
        if sample_override is not None:
            u_norm = sample_override(ctx, noise)
        else:
            u_norm = diffusion.ddpm_cfg_sample(
                denoise, (k, horizon, control_dim), ctx, w=w,
                n_diffusion_steps_without_noise=n_diffusion_steps_without_noise, noise=noise)
        u_cand = unnormalize(inputs_stats, u_norm)
        if k == 1:
            return u_cand[0], u_cand
        x = x0.expand(k, x0.shape[-1])
        acc = torch.zeros((k,), dtype=torch.float32, device=x0.device)
        for i in range(sel_h):
            u = u_cand[:, i, :]
            acc = acc + cost.stage(x, u)
            x = plant.step(x, u)
        if sel_h == horizon:
            acc = acc + cost.terminal(x)
        # torch.argmin's rule is jnp.argmin's: the first minimum, and the first
        # NaN when a score is NaN (tests/test_torch_port_episode.py pins it)
        return u_cand[torch.argmin(acc)], u_cand

    return replan


def make_closed_loop(diffusion: GaussianDiffusion, denoise: DenoiseFn,
                     inputs_stats: NormalizerStats, condition_stats: NormalizerStats,
                     plant: Plant, cost: QuadraticCost, horizon: int, n_steps: int = 80,
                     w: float = 0.01, n_diffusion_steps_without_noise: int = 5,
                     n_candidates: int = 1, state_to_condition: Optional[Callable] = None,
                     sample_override: Optional[SampleFn] = None,
                     selection_horizon: Optional[int] = None, noise_shape=None, device=None):
    """``closed_loop(x0, noise=None, generator=None) -> ClosedLoopResult`` on
    ``device`` (``cuda`` unless given). ``noise`` is (n_steps, *noise_shape),
    one replan's noise per row; without it each replan's noise is drawn from
    ``generator``. ``noise_shape`` defaults to the ``noise_shape`` attribute
    of ``sample_override`` where it has one (a ``FusedDdimChain``'s is its
    x_init, (K, horizon, control_dim)), else to the CFG DDPM layout
    (n_total + 1, K, horizon, control_dim). Defaults are the flagship run's:
    80 replans, T = 25 + 5, w = 0.01, K = 1."""
    dev = resolve_device(device)
    inputs_stats, condition_stats = inputs_stats.to(dev), condition_stats.to(dev)
    cost = cost.to(dev)
    replan = make_replan_fn(diffusion, denoise, inputs_stats, condition_stats, horizon,
                            plant.control_dim, w, n_diffusion_steps_without_noise, n_candidates,
                            plant, cost, state_to_condition, sample_override, selection_horizon)
    if noise_shape is None:
        n_total = diffusion.schedule.n_steps + n_diffusion_steps_without_noise
        noise_shape = (n_total + 1, int(n_candidates), horizon, plant.control_dim)
    noise_shape = (n_steps, *noise_shape)

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
        for i in range(n_steps):
            u_hor, _ = replan(x, noise[i])
            u0 = u_hor[0]
            stages.append(cost.stage(x, u0))
            x = plant.step(x, u0)
            xs.append(x)
            us.append(u0)
            u_hors.append(u_hor)
        return ClosedLoopResult(x_track=torch.stack(xs), u_track=torch.stack(us),
                                u_horizons=torch.stack(u_hors), stage_costs=torch.stack(stages))

    return closed_loop
