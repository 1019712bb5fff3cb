"""CFG DDPM sampling: port of ``GaussianDiffusion.ddpm_cfg_step`` and
``ddpm_cfg_sample`` of ``mpc_via_diffusion_model_tpu/diffusion/gaussian_diffusion.py``.

Semantics kept: one noise draw of shape (n_total + 1, *shape) per chain,
where ``[0]`` is x_T and ``[1 + s]`` is injected at step s; the noise-free
tail clamps t < 0 to t = 0; the noise is gated off at i <= 0; the x0
reconstructions of the doubled batch combine as (1 + w) cond - w uncond,
then clip to [-1, 1]. The model predicts epsilon, as every model of the
JAX package's CFG path does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..core.schedules import DiffusionSchedule

__all__ = ["GaussianDiffusion"]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    schedule: DiffusionSchedule

    def _extract(self, table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
        out = table.to(t.device)[t]
        return out.reshape(out.shape + (1,) * (ndim - 1))

    def predict_start_from_noise(self, x_t, t, model_out):
        s = self.schedule
        return (self._extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
                - self._extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * model_out)

    def q_posterior(self, x_start, x_t, t) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.schedule
        mean = (self._extract(s.posterior_mean_coef1, t, x_t.ndim) * x_start
                + self._extract(s.posterior_mean_coef2, t, x_t.ndim) * x_t)
        return mean, self._extract(s.posterior_log_variance_clipped, t, x_t.ndim)

    def p_mean_variance_cfg(self, denoise_fn: DenoiseFn, x, t, context, w: float):
        """CFG posterior with the two U-Net passes as one doubled batch."""
        b = x.shape[0]
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.cat([t, t], dim=0)
        ctx2 = torch.cat([context, context], dim=0)
        mask2 = torch.cat([torch.zeros((b, 1), dtype=x.dtype, device=x.device),
                           torch.ones((b, 1), dtype=x.dtype, device=x.device)], dim=0)
        recon2 = self.predict_start_from_noise(x2, t2, denoise_fn(x2, t2, ctx2, mask2))
        x_recon = torch.clamp((1.0 + w) * recon2[:b] - w * recon2[b:], -1.0, 1.0)
        return self.q_posterior(x_recon, x, t)

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
