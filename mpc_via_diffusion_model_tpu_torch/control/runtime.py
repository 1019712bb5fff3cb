"""Receding-horizon loops: port of ``make_replan_fn``, ``make_closed_loop``
(the ``ddpm`` and ``ddim`` samplers, best-of-K candidates,
``selection_horizon`` and cost-gradient guidance) and
``make_nmpc_closed_loop`` (the iLQR expert) and ``make_ampc_closed_loop``
(the AMPC MLP baseline) of ``mpc_via_diffusion_model_tpu/control/runtime.py``.

Each replan maps the plant state to the condition (``state_to_condition``,
identity by default), normalizes it, samples K control horizons with the
CFG DDPM chain, the DDIM sampler or a ``sample_override``, unnormalizes them
and, for K > 1, applies the first control of the candidate whose rollout
costs least. The JAX loop splits one key per replan and hands it to the
sampler; here each replan takes its own slice of staged noise, or draws it
from a ``torch.Generator``, in the sampler's per-replan layout: (n_total +
1, K, H, du), ``ddpm_cfg_sample``'s, by default; (n_pairs + 1, K, H, du),
``ddim_sample``'s, for ``sampler='ddim'``; the ``noise_shape`` the caller
names, or else the override's own ``noise_shape``, e.g. (K, H, du), the
``x_init`` of a distilled student's DDIM chain.

A batch of N states (x0 (N, n)) runs as one loop, which is what the JAX
package gets from ``jax.vmap`` of its loop: the sampler draws the N * K rows
as one batch, row j belonging to state j // K, each state's candidates
scored from that state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..data.normalization import NormalizerStats, normalize, unnormalize
from ..diffusion.gaussian_diffusion import DenoiseFn, GaussianDiffusion, ddim_times
from ..dynamics.base import Plant, QuadraticCost
from ..solvers.ilqr import ILQRConfig, ilqr_solve
from ..utils.device import resolve_device

__all__ = ["ClosedLoopResult", "make_replan_fn", "make_closed_loop", "make_nmpc_closed_loop",
           "make_ampc_closed_loop"]

SampleFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ClosedLoopResult:
    x_track: torch.Tensor      # (..., n_steps + 1, state_dim)
    u_track: torch.Tensor      # (..., n_steps, control_dim)
    u_horizons: torch.Tensor   # (..., n_steps, horizon, control_dim) applied plans
    stage_costs: torch.Tensor  # (..., n_steps)


def make_replan_fn(diffusion: GaussianDiffusion, denoise: DenoiseFn,
                   inputs_stats: NormalizerStats, condition_stats: NormalizerStats,
                   horizon: int, control_dim: int = 1, w: float = 0.01,
                   n_diffusion_steps_without_noise: int = 5, n_candidates: int = 1,
                   plant: Optional[Plant] = None, cost: Optional[QuadraticCost] = None,
                   state_to_condition: Optional[Callable] = None,
                   sample_override: Optional[SampleFn] = None,
                   selection_horizon: Optional[int] = None,
                   guide_builder: Optional[Callable] = None, n_guide_steps: int = 1,
                   t_start_guide: float = float("inf"), sampler: str = "ddpm"):
    """``replan(x0, noise) -> (u_horizon, u_candidates)``: for x0 (n,) they
    are (H, du) and (K, H, du); for x0 (N, n) (N, H, du) and (N, K, H, du),
    and ``noise`` is (N, *noise_shape), one state's per-replan noise per row.

    ``denoise(x, t, context, context_mask) -> eps`` is the denoiser: a
    ``TemporalUnet``, or a ``FusedUnet`` (built for 2 N K rows) as
    ``bench.py``'s ``BENCH_FUSED=1`` and the guided loops pass it.
    ``sample_override(context_norm (N K, dc), noise) -> u_norm (N K, H, du)``
    replaces the sampler, e.g. a ``FusedCfgChain``, or a distilled student's
    DDIM chain (``FusedDdimChain``, ``make_student_ddim_sampler``) whose
    noise is its x_init. For K > 1 candidates are scored by ``cost`` over
    their rollout from the plant state, truncated to ``selection_horizon``
    steps (terminal cost only when the whole plan is scored).

    ``guide_builder(x0) -> guide`` builds each replan's cost-gradient guide
    on normalized plans from the state(s) x0, which the sampler applies on
    its steps i < ``t_start_guide``, ``n_guide_steps`` times; batched, the
    guide gets (N K, H, du), row j from state j // K. It cannot compose with
    ``sample_override``, which replaces the sampler. ``sampler='ddim'``
    samples by ``ddim_sample`` with a zero context mask for the conditional
    pass."""
    k = int(n_candidates)
    if k > 1 and (plant is None or cost is None):
        raise ValueError("candidate selection needs plant and cost")
    if guide_builder is not None and sample_override is not None:
        raise ValueError("guide_builder cannot compose with sample_override: the override "
                         "replaces the sampler (guidance must be baked into it)")
    if sampler not in ("ddpm", "ddim"):
        raise ValueError(f"unknown sampler '{sampler}'")
    to_cond = state_to_condition or (lambda x: x)
    sel_h = int(selection_horizon or horizon)
    if not 1 <= sel_h <= horizon:
        raise ValueError(f"selection_horizon must be in 1..{horizon}, got {selection_horizon}")

    def masked(x, t, c, m):
        return denoise(x, t, c, torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
                       if m is None else m)

    def sample(ctx: torch.Tensor, noise: torch.Tensor, guide) -> torch.Tensor:
        if sample_override is not None:
            return sample_override(ctx, noise)
        shape = (ctx.shape[0], horizon, control_dim)
        if sampler == "ddpm":
            return diffusion.ddpm_cfg_sample(
                denoise, shape, ctx, w=w,
                n_diffusion_steps_without_noise=n_diffusion_steps_without_noise, noise=noise,
                guide=guide, n_guide_steps=n_guide_steps, t_start_guide=t_start_guide)
        return diffusion.ddim_sample(masked, shape, context=ctx, w=w, guide=guide,
                                     n_guide_steps=n_guide_steps, t_start_guide=t_start_guide,
                                     noise=noise)

    def replan(x0: torch.Tensor, noise: torch.Tensor):
        batched = x0.dim() == 2
        xb = x0 if batched else x0[None]
        n = xb.shape[0]
        cond_norm = normalize(condition_stats, to_cond(xb))
        ctx = cond_norm[:, None].expand(n, k, cond_norm.shape[-1]).reshape(n * k, -1)
        if batched:  # (N, ..., K, H, du) -> (..., N K, H, du)
            noise = noise.movedim(0, -4).flatten(-4, -3)
        guide = guide_builder(x0) if guide_builder is not None else None
        u_cand = unnormalize(inputs_stats, sample(ctx, noise, guide))
        u_cand = u_cand.reshape(n, k, *u_cand.shape[1:])
        if k == 1:
            best = u_cand[:, 0]
        else:
            x = xb[:, None].expand(n, k, xb.shape[-1])
            acc = torch.zeros((n, k), dtype=torch.float32, device=x0.device)
            for i in range(sel_h):
                u = u_cand[:, :, i, :]
                acc = acc + cost.stage(x, u)
                x = plant.step(x, u)
            if sel_h == horizon:
                acc = acc + cost.terminal(x)
            # torch.argmin's rule is jnp.argmin's: the first minimum, and the first
            # NaN when a score is NaN (tests/test_torch_port_episode.py pins it)
            best = u_cand[torch.arange(n, device=x0.device), torch.argmin(acc, dim=1)]
        return (best, u_cand) if batched else (best[0], u_cand[0])

    return replan


def make_closed_loop(diffusion: GaussianDiffusion, denoise: DenoiseFn,
                     inputs_stats: NormalizerStats, condition_stats: NormalizerStats,
                     plant: Plant, cost: QuadraticCost, horizon: int, n_steps: int = 80,
                     w: float = 0.01, n_diffusion_steps_without_noise: int = 5,
                     n_candidates: int = 1, state_to_condition: Optional[Callable] = None,
                     sample_override: Optional[SampleFn] = None,
                     selection_horizon: Optional[int] = None, noise_shape=None, device=None,
                     guide_builder: Optional[Callable] = None, n_guide_steps: int = 1,
                     t_start_guide: float = float("inf"), sampler: str = "ddpm"):
    """``closed_loop(x0, noise=None, generator=None) -> ClosedLoopResult`` on
    ``device`` (``cuda`` unless given). x0 is one state (n,) or a batch (N,
    n); ``noise`` is (n_steps, *noise_shape), or (N, n_steps, *noise_shape),
    one replan's noise per row of each state; without it the noise is drawn
    from ``generator``. ``noise_shape`` is one state's: by default the
    ``noise_shape`` attribute of ``sample_override`` where it has one, its
    candidate axis (third from last) set to K (a ``FusedDdimChain``'s is its
    x_init, (B, horizon, control_dim), B = N K), else the sampler's layout:
    (n_total + 1, K, horizon, control_dim) for ``ddpm``, (n_pairs + 1, K,
    horizon, control_dim) for ``ddim``. ``guide_builder``, ``n_guide_steps``,
    ``t_start_guide`` and ``sampler`` are ``make_replan_fn``'s; the loop runs
    under ``torch.no_grad()``, so a guide opens its own autograd. Defaults
    are the flagship run's: 80 replans, T = 25 + 5, w = 0.01, K = 1."""
    dev = resolve_device(device)
    inputs_stats, condition_stats = inputs_stats.to(dev), condition_stats.to(dev)
    cost = cost.to(dev)
    k = int(n_candidates)
    replan = make_replan_fn(diffusion, denoise, inputs_stats, condition_stats, horizon,
                            plant.control_dim, w, n_diffusion_steps_without_noise, k,
                            plant, cost, state_to_condition, sample_override, selection_horizon,
                            guide_builder, n_guide_steps, t_start_guide, sampler)
    if noise_shape is None and getattr(sample_override, "noise_shape", None) is not None:
        ns = tuple(sample_override.noise_shape)
        noise_shape = (*ns[:-3], k, *ns[-2:])
    if noise_shape is None:
        n_rows = (diffusion.schedule.n_steps + n_diffusion_steps_without_noise + 1
                  if sampler == "ddpm" else len(ddim_times(diffusion.schedule.n_steps)))
        noise_shape = (n_rows, k, horizon, plant.control_dim)
    noise_shape = (n_steps, *noise_shape)

    @torch.no_grad()
    def closed_loop(x0: torch.Tensor, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> ClosedLoopResult:
        x = x0.to(device=dev, dtype=torch.float32)
        if x.dim() not in (1, 2):
            raise ValueError(f"x0 must be (n,) or (N, n), got {tuple(x.shape)}")
        lead = tuple(x.shape[:-1])
        want = lead + noise_shape
        if noise is None:
            noise = torch.randn(want, generator=generator, dtype=torch.float32, device=dev)
        elif tuple(noise.shape) != want:
            raise ValueError(f"noise must be {want}, got {tuple(noise.shape)}")
        noise = noise.to(dev)
        xs, us, u_hors, stages = [x], [], [], []
        for i in range(n_steps):
            u_hor, _ = replan(x, noise.select(len(lead), i))
            u0 = u_hor[..., 0, :]
            stages.append(cost.stage(x, u0))
            x = plant.step(x, u0)
            xs.append(x)
            us.append(u0)
            u_hors.append(u_hor)
        return ClosedLoopResult(x_track=torch.stack(xs, dim=-2), u_track=torch.stack(us, dim=-2),
                                u_horizons=torch.stack(u_hors, dim=len(lead)),
                                stage_costs=torch.stack(stages, dim=-1))

    return closed_loop


def make_nmpc_closed_loop(plant: Plant, cost: QuadraticCost, solver_config: ILQRConfig,
                          n_steps: int = 80, u_init_scale: float = 0.0, warm_start: bool = True,
                          device=None):
    """``closed_loop(x0) -> ClosedLoopResult``: the iLQR expert's receding
    horizon on ``device`` (``cuda`` unless given), one ``ilqr_solve`` per
    step, the first control applied. The first solve starts from the
    constant ``u_init_scale`` (the swing basin's sign); each later one from
    the previous solution shifted by a step (its last control repeated), or
    from the constant again without ``warm_start``. ``x0`` (..., n) may
    carry batch axes: the tracks are then (..., n_steps + 1, n) and so on."""
    dev = resolve_device(device)
    cost = cost.to(dev)

    @torch.no_grad()
    def closed_loop(x0: torch.Tensor) -> ClosedLoopResult:
        x = x0.to(device=dev, dtype=torch.float32)
        u_init = torch.full((*x.shape[:-1], solver_config.horizon, plant.control_dim),
                            float(u_init_scale), dtype=torch.float32, device=dev)
        u_ws, xs, us, u_hors, stages = u_init, [x], [], [], []
        for _ in range(n_steps):
            sol = ilqr_solve(plant, cost, x, u_ws, solver_config)
            u0 = sol.us[..., 0, :]
            stages.append(cost.stage(x, u0))
            x = plant.step(x, u0)
            u_ws = torch.cat([sol.us[..., 1:, :], sol.us[..., -1:, :]], dim=-2) if warm_start \
                else u_init
            xs.append(x)
            us.append(u0)
            u_hors.append(sol.us)
        return ClosedLoopResult(x_track=torch.stack(xs, dim=-2), u_track=torch.stack(us, dim=-2),
                                u_horizons=torch.stack(u_hors, dim=-3),
                                stage_costs=torch.stack(stages, dim=-1))

    return closed_loop


def make_ampc_closed_loop(ampc: Callable[[torch.Tensor], torch.Tensor],
                          inputs_stats: NormalizerStats, condition_stats: NormalizerStats,
                          plant: Plant, cost: QuadraticCost, n_steps: int = 80,
                          state_to_condition: Optional[Callable] = None, device=None):
    """``closed_loop(x0) -> ClosedLoopResult``: the AMPC MLP baseline's loop
    on ``device`` (``cuda`` unless given). Each step ``ampc`` (an
    ``AMPCNet``, or any ``(1, C) normalized condition -> (1, H, du)``
    callable) regresses the whole normalized control horizon from the
    normalized state; the horizon is unnormalized and its first control
    applied. Deterministic: no sampling."""
    dev = resolve_device(device)
    inputs_stats, condition_stats = inputs_stats.to(dev), condition_stats.to(dev)
    cost = cost.to(dev)
    to_cond = state_to_condition or (lambda x: x)

    @torch.no_grad()
    def closed_loop(x0: torch.Tensor) -> ClosedLoopResult:
        x = x0.to(device=dev, dtype=torch.float32)
        xs, us, u_hors, stages = [x], [], [], []
        for _ in range(n_steps):
            cond = normalize(condition_stats, to_cond(x))[None, :]
            u_hor = unnormalize(inputs_stats, ampc(cond))[0]
            u0 = u_hor[0]
            stages.append(cost.stage(x, u0))
            x = plant.step(x, u0)
            xs.append(x)
            us.append(u0)
            u_hors.append(u_hor)
        return ClosedLoopResult(x_track=torch.stack(xs), u_track=torch.stack(us),
                                u_horizons=torch.stack(u_hors), stage_costs=torch.stack(stages))

    return closed_loop
