"""Gaussian diffusion: port of ``GaussianDiffusion`` of
``mpc_via_diffusion_model_tpu/diffusion/gaussian_diffusion.py``, its CFG
DDPM sampler and its training half (``q_sample``, ``loss``,
``p_mean_variance``, ``apply_hard_conds``).

Sampling semantics kept: one noise draw of shape (n_total + 1, *shape) per
chain, where ``[0]`` is x_T and ``[1 + s]`` is injected at step s; the
noise-free tail clamps t < 0 to t = 0; the noise is gated off at i <= 0;
the x0 reconstructions of the doubled batch combine as (1 + w) cond - w
uncond, then clip to [-1, 1] when ``clip_denoised``.

Training semantics kept: t ~ U[0, T), the context dropped per row with
probability ``drop_prob`` (mask 1 = dropped), no mask at all without a
context, and the ``loss_type`` loss of the prediction against epsilon, or
against x0 when ``predict_epsilon`` is False. The draws are staged by the
caller or drawn from a ``torch.Generator`` on the data's device.

The unguided ``ddpm_step``, ``ddpm_sample`` and ``ddim_sample`` wait for
the port of ``diffusion/guides.py`` (ROADMAP.md A3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..core.losses import LOSSES
from ..core.schedules import DiffusionSchedule

__all__ = ["GaussianDiffusion", "HardConds", "apply_hard_conds"]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
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
    def ddpm_cfg_step(self, denoise_fn: DenoiseFn, x, i: int, noise, context, w: float):
        """One CFG step with its injected noise passed in: t < 0 clamps to
        t = 0, and the noise is zeroed whenever i <= 0."""
        t = torch.full((x.shape[0],), max(i, 0), dtype=torch.long, device=x.device)
        mean, log_var = self.p_mean_variance_cfg(denoise_fn, x, t, context, w)
        noise_gate = 1.0 if i > 0 else 0.0
        return mean + torch.exp(0.5 * log_var) * noise * noise_gate

    @torch.no_grad()
    def ddpm_cfg_sample(self, denoise_fn: DenoiseFn, shape: Tuple[int, ...], context,
                        w: float = 0.01, n_diffusion_steps_without_noise: int = 0,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """CFG DDPM sampling. ``noise`` (n_total + 1, *shape) is staged by the
        caller, or drawn here from ``generator`` on the context's device."""
        n_total = self.schedule.n_steps + n_diffusion_steps_without_noise
        if noise is None:
            noise = torch.randn((n_total + 1,) + tuple(shape), generator=generator,
                                dtype=torch.float32, device=context.device)
        elif tuple(noise.shape) != (n_total + 1,) + tuple(shape):
            raise ValueError(f"noise must be {(n_total + 1,) + tuple(shape)}, got {tuple(noise.shape)}")
        x = noise[0]
        for s, i in enumerate(range(self.schedule.n_steps - 1, -n_diffusion_steps_without_noise - 1, -1)):
            x = self.ddpm_cfg_step(denoise_fn, x, i, noise[s + 1], context, w)
        return x
