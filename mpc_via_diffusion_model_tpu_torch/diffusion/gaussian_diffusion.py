"""Gaussian diffusion: port of ``GaussianDiffusion`` of
``mpc_via_diffusion_model_tpu/diffusion/gaussian_diffusion.py``, its CFG
DDPM sampler and its training half (``q_sample``, ``loss``,
``p_mean_variance``, ``apply_hard_conds``).

Sampling semantics kept: one noise draw of shape (n_total + 1, *shape) per
chain, where ``[0]`` is x_T and ``[1 + s]`` is injected at step s; the
noise-free tail clamps t < 0 to t = 0; the noise is gated off at i <= 0;
the x0 reconstructions of the doubled batch combine as (1 + w) cond - w
uncond, then clip to [-1, 1] when ``clip_denoised``.

Cost-gradient guidance (the JAX package's ``guide`` hooks): ``guide(x) ->
delta`` acts on the posterior mean before the noise is added,
``n_guide_steps`` times, each step scaled by exp(log_var) with
``scale_grad_by_std``, on the loop's steps i < ``t_start_guide`` (the
noise-free tail included); ``ddpm_step``/``ddpm_sample`` (one U-Net pass,
hard conditions after each guide step and after the noise) and
``ddim_sample`` (JAX's time grid, CFG without a clip, ``eta``, the guide
while time_next < ``t_start_guide``) take the same hooks.

Training semantics kept: t ~ U[0, T), the context dropped per row with
probability ``drop_prob`` (mask 1 = dropped), no mask at all without a
context, and the ``loss_type`` loss of the prediction against epsilon, or
against x0 when ``predict_epsilon`` is False. The draws are staged by the
caller or drawn from a ``torch.Generator`` on the data's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.losses import LOSSES
from ..core.schedules import DiffusionSchedule

__all__ = ["GaussianDiffusion", "HardConds", "apply_hard_conds", "ddim_times"]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
GuideFn = Callable[[torch.Tensor], torch.Tensor]
# Hard (inpainting) conditions: (timestep indices (K,), values (B, K, D)).
HardConds = Optional[Tuple[torch.Tensor, torch.Tensor]]


def apply_hard_conds(x: torch.Tensor, hard_conds: HardConds) -> torch.Tensor:
    """A copy of x with x[:, idx, :] = values."""
    if hard_conds is None:
        return x
    idx, values = hard_conds
    x = x.clone()
    x[:, idx, :] = values.to(x.dtype)
    return x


def ddim_times(n_steps: int, sampling_timesteps: Optional[int] = None):
    """The (time, time_next) pairs of ``ddim_sample``: the JAX package's grid,
    ``np.linspace(0, T - 1, n + 1)`` rounded by Python's ``round``, -1 at the
    end, walked from T - 1 down; n = T // 5 (at least 1) unless given."""
    n = sampling_timesteps or max(n_steps // 5, 1)
    times = [-1] + [int(round(v)) for v in np.linspace(0, n_steps - 1, n + 1)]
    times = list(reversed(times))
    return list(zip(times[:-1], times[1:]))


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    schedule: DiffusionSchedule
    predict_epsilon: bool = True
    clip_denoised: bool = True
    loss_type: str = "l2"
    drop_prob: float = 0.25

    def to(self, device) -> "GaussianDiffusion":
        """A copy with the schedule's tables on ``device``, so that a loop on
        the card gathers its coefficients without host copies."""
        s = self.schedule
        tables = {f.name: getattr(s, f.name).to(device) for f in dataclasses.fields(s)
                  if f.name != "n_steps"}
        return dataclasses.replace(self, schedule=DiffusionSchedule(s.n_steps, **tables))

    def _extract(self, table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
        out = table.to(t.device)[t]
        return out.reshape(out.shape + (1,) * (ndim - 1))

    def predict_start_from_noise(self, x_t, t, model_out):
        if not self.predict_epsilon:
            return model_out
        s = self.schedule
        return (self._extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
                - self._extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * model_out)

    def predict_noise_from_start(self, x_t, t, x0):
        """With ``predict_epsilon`` the model output already is epsilon and
        comes back unchanged, as in the JAX package."""
        if self.predict_epsilon:
            return x0
        s = self.schedule
        return ((self._extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0)
                / self._extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))

    def q_posterior(self, x_start, x_t, t) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.schedule
        mean = (self._extract(s.posterior_mean_coef1, t, x_t.ndim) * x_start
                + self._extract(s.posterior_mean_coef2, t, x_t.ndim) * x_t)
        return mean, self._extract(s.posterior_log_variance_clipped, t, x_t.ndim)

    def _clip_recon(self, x_recon):
        return torch.clamp(x_recon, -1.0, 1.0) if self.clip_denoised else x_recon

    def p_mean_variance(self, denoise_fn: DenoiseFn, x, t, context):
        """Single-pass posterior parameters (no context mask)."""
        x_recon = self._clip_recon(
            self.predict_start_from_noise(x, t, denoise_fn(x, t, context, None)))
        return self.q_posterior(x_recon, x, t)

    def p_mean_variance_cfg(self, denoise_fn: DenoiseFn, x, t, context, w: float):
        """CFG posterior with the two U-Net passes as one doubled batch."""
        b = x.shape[0]
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.cat([t, t], dim=0)
        ctx2 = torch.cat([context, context], dim=0)
        mask2 = torch.cat([torch.zeros((b, 1), dtype=x.dtype, device=x.device),
                           torch.ones((b, 1), dtype=x.dtype, device=x.device)], dim=0)
        recon2 = self.predict_start_from_noise(x2, t2, denoise_fn(x2, t2, ctx2, mask2))
        x_recon = self._clip_recon((1.0 + w) * recon2[:b] - w * recon2[b:])
        return self.q_posterior(x_recon, x, t)

    # training
    def q_sample(self, x_start, t, noise):
        """Forward noising: sqrt(abar_t) x0 + sqrt(1 - abar_t) noise."""
        s = self.schedule
        return (self._extract(s.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
                + self._extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)

    def loss(self, denoise_fn: DenoiseFn, x_start: torch.Tensor, context: Optional[torch.Tensor],
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The training loss of one batch x_start (B, H, D) with its context
        (B, C) or None. ``t`` (B,), ``noise`` (B, H, D) and ``mask`` (B, 1)
        are staged by the caller; each one missing is drawn here from
        ``generator``, in the order t, noise, mask (the mask only with a
        context). The JAX package's per-sample ``sample_keys`` belong to
        data-parallel training and wait for it (ROADMAP.md A9)."""
        b, dev = x_start.shape[0], x_start.device
        if t is None:
            t = torch.randint(0, self.schedule.n_steps, (b,), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, dtype=x_start.dtype,
                                device=dev)
        context_mask = None
        if context is not None:
            if mask is None:
                mask = torch.rand((b, 1), generator=generator, device=dev) < self.drop_prob
            context_mask = mask.to(x_start.dtype)
        x_noisy = self.q_sample(x_start, t, noise)
        x_recon = denoise_fn(x_noisy, t, context, context_mask)
        target = noise if self.predict_epsilon else x_start
        return LOSSES[self.loss_type](x_recon, target)

    # sampling
    def _guide_steps(self, x, log_var, guide: Optional[GuideFn], n_guide_steps: int,
                     scale_grad_by_std: bool, hard_conds: HardConds = None):
        """``n_guide_steps`` guide steps on x, each scaled by exp(log_var)
        with ``scale_grad_by_std``, the hard conditions applied after each."""
        for _ in range(n_guide_steps):
            g = guide(x)
            if scale_grad_by_std:
                g = torch.exp(log_var) * g
            x = apply_hard_conds(x + g, hard_conds)
        return x

    def ddpm_cfg_step(self, denoise_fn: DenoiseFn, x, i: int, noise, context, w: float,
                      guide: Optional[GuideFn] = None, n_guide_steps: int = 1,
                      t_start_guide: float = float("inf"), scale_grad_by_std: bool = False):
        """One CFG step with its injected noise passed in: t < 0 clamps to
        t = 0, and the noise is zeroed whenever i <= 0. ``guide`` moves the
        posterior mean before the noise on steps i < ``t_start_guide``.

        The JAX package calls the guide on every step and multiplies its
        step by 0 outside the window; skipping the call there gives the same
        numbers only because the guide's output is finite (the quadrotor's
        ``make_penalty_grad`` sets non-finite gradients to 0)."""
        t = torch.full((x.shape[0],), max(i, 0), dtype=torch.long, device=x.device)
        mean, log_var = self.p_mean_variance_cfg(denoise_fn, x, t, context, w)
        if guide is not None and i < t_start_guide:
            mean = self._guide_steps(mean, log_var, guide, n_guide_steps, scale_grad_by_std)
        noise_gate = 1.0 if i > 0 else 0.0
        return mean + torch.exp(0.5 * log_var) * noise * noise_gate

    @staticmethod
    def _staged_noise(n_rows: int, shape: Tuple[int, ...], noise: Optional[torch.Tensor],
                      generator: Optional[torch.Generator], device) -> torch.Tensor:
        """A sampler's noise (n_rows, *shape): ``noise`` checked, or drawn from
        ``generator`` on ``device``."""
        want = (n_rows,) + tuple(shape)
        if noise is None:
            return torch.randn(want, generator=generator, dtype=torch.float32, device=device)
        if tuple(noise.shape) != want:
            raise ValueError(f"noise must be {want}, got {tuple(noise.shape)}")
        return noise

    @torch.no_grad()
    def ddpm_cfg_sample(self, denoise_fn: DenoiseFn, shape: Tuple[int, ...], context,
                        w: float = 0.01, n_diffusion_steps_without_noise: int = 0,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None, return_chain: bool = False,
                        guide: Optional[GuideFn] = None, n_guide_steps: int = 1,
                        t_start_guide: float = float("inf"), scale_grad_by_std: bool = False):
        """CFG DDPM sampling. ``noise`` (n_total + 1, *shape) is staged by the
        caller, or drawn here from ``generator`` on the context's device.
        With ``return_chain`` also every x of the chain, x_T first: (x,
        (n_total + 1, *shape))."""
        n_tail = n_diffusion_steps_without_noise
        noise = self._staged_noise(self.schedule.n_steps + n_tail + 1, shape, noise, generator,
                                   context.device)
        x = noise[0]
        chain = [x]
        for s, i in enumerate(range(self.schedule.n_steps - 1, -n_tail - 1, -1)):
            x = self.ddpm_cfg_step(denoise_fn, x, i, noise[s + 1], context, w, guide,
                                   n_guide_steps, t_start_guide, scale_grad_by_std)
            chain.append(x)
        return (x, torch.stack(chain)) if return_chain else x

    def ddpm_step(self, denoise_fn: DenoiseFn, x, i: int, noise, context=None,
                  hard_conds: HardConds = None, guide: Optional[GuideFn] = None,
                  n_guide_steps: int = 1, t_start_guide: float = float("inf"),
                  scale_grad_by_std: bool = False,
                  noise_std_extra_schedule_fn: Optional[Callable[[int], float]] = None):
        """One plain DDPM step (one U-Net pass, no context mask): the guide
        as in ``ddpm_cfg_step`` with the hard conditions applied after each
        guide step, the noise times ``noise_std_extra_schedule_fn(i)`` where
        given, then the hard conditions again."""
        t = torch.full((x.shape[0],), max(i, 0), dtype=torch.long, device=x.device)
        mean, log_var = self.p_mean_variance(denoise_fn, x, t, context)
        if guide is not None and i < t_start_guide:
            mean = self._guide_steps(mean, log_var, guide, n_guide_steps, scale_grad_by_std,
                                     hard_conds)
        noise_std = 1.0 if noise_std_extra_schedule_fn is None else noise_std_extra_schedule_fn(i)
        noise_gate = 1.0 if i > 0 else 0.0
        x = mean + torch.exp(0.5 * log_var) * noise * noise_std * noise_gate
        return apply_hard_conds(x, hard_conds)

    @torch.no_grad()
    def ddpm_sample(self, denoise_fn: DenoiseFn, shape: Tuple[int, ...], context=None,
                    hard_conds: HardConds = None, n_diffusion_steps_without_noise: int = 0,
                    guide: Optional[GuideFn] = None, n_guide_steps: int = 1,
                    t_start_guide: float = float("inf"), scale_grad_by_std: bool = False,
                    noise_std_extra_schedule_fn: Optional[Callable[[int], float]] = None,
                    return_chain: bool = False, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None, device=None):
        """Plain DDPM ancestral sampling in the layout of ``ddpm_cfg_sample``:
        ``noise`` (n_total + 1, *shape), [0] the hard-conditioned x_T, staged
        or drawn from ``generator`` on the context's device (``device``
        without a context)."""
        n_tail = n_diffusion_steps_without_noise
        noise = self._staged_noise(self.schedule.n_steps + n_tail + 1, shape, noise, generator,
                                   context.device if context is not None else device)
        x = apply_hard_conds(noise[0], hard_conds)
        chain = [x]
        for s, i in enumerate(range(self.schedule.n_steps - 1, -n_tail - 1, -1)):
            x = self.ddpm_step(denoise_fn, x, i, noise[s + 1], context, hard_conds, guide,
                               n_guide_steps, t_start_guide, scale_grad_by_std,
                               noise_std_extra_schedule_fn)
            chain.append(x)
        return (x, torch.stack(chain)) if return_chain else x

    @torch.no_grad()
    def ddim_sample(self, denoise_fn: DenoiseFn, shape: Tuple[int, ...], context=None,
                    hard_conds: HardConds = None, sampling_timesteps: Optional[int] = None,
                    eta: float = 0.0, w: float = 0.0, guide: Optional[GuideFn] = None,
                    n_guide_steps: int = 1, t_start_guide: float = float("inf"),
                    return_chain: bool = False, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None, device=None):
        """DDIM over ``ddim_times``. ``noise`` (n + 1, *shape) is staged by the
        caller or drawn from ``generator``: [0] is x_init (the JAX package's
        ``k_init`` draw), [1 + s] the noise of pair s (its ``k_loop`` splits).

        ``w != 0`` with a context: one doubled-batch pass, x0 = (1 + w) cond -
        w uncond, and epsilon re-derived from it exactly; without, the
        conditional pass alone. Neither branch clips x0, whatever
        ``clip_denoised`` says. The guide acts, unscaled, after the DDIM
        update of each pair whose time_next < ``t_start_guide``, before the
        eta noise; the hard conditions follow each guide step and the noise.
        With ``return_chain`` also x_init and every pair's x: (x, (n + 2,
        *shape))."""
        s = self.schedule
        pairs = ddim_times(s.n_steps, sampling_timesteps)
        noise = self._staged_noise(len(pairs), shape, noise, generator,
                                   context.device if context is not None else device)
        x = apply_hard_conds(noise[0], hard_conds)
        chain = [x]
        b = shape[0]
        use_cfg = w != 0.0 and context is not None
        for p, (time, time_next) in enumerate(pairs):
            t = torch.full((b,), time, dtype=torch.long, device=x.device)
            if use_cfg:
                x2, t2 = torch.cat([x, x], dim=0), torch.cat([t, t], dim=0)
                mask2 = torch.cat([torch.zeros((b, 1), dtype=x.dtype, device=x.device),
                                   torch.ones((b, 1), dtype=x.dtype, device=x.device)], dim=0)
                recon2 = self.predict_start_from_noise(
                    x2, t2, denoise_fn(x2, t2, torch.cat([context, context], dim=0), mask2))
                x_start = (1.0 + w) * recon2[:b] - w * recon2[b:]
                pred_noise = ((self._extract(s.sqrt_recip_alphas_cumprod, t, x.ndim) * x - x_start)
                              / self._extract(s.sqrt_recipm1_alphas_cumprod, t, x.ndim))
            else:
                model_out = denoise_fn(x, t, context, None)
                x_start = self.predict_start_from_noise(x, t, model_out)
                pred_noise = self.predict_noise_from_start(x, t, model_out)
            if time_next < 0:
                x = apply_hard_conds(x_start, hard_conds)
                chain.append(x)
                break
            t_next = torch.full((b,), time_next, dtype=torch.long, device=x.device)
            alpha = self._extract(s.alphas_cumprod, t, x.ndim)
            alpha_next = self._extract(s.alphas_cumprod, t_next, x.ndim)
            sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
            c = torch.sqrt(1 - alpha_next - sigma ** 2)
            x = x_start * torch.sqrt(alpha_next) + c * pred_noise
            if guide is not None and time_next < t_start_guide:
                x = self._guide_steps(x, None, guide, n_guide_steps, False, hard_conds)
            x = apply_hard_conds(x + sigma * noise[1 + p], hard_conds)
            chain.append(x)
        return (x, torch.stack(chain)) if return_chain else x
