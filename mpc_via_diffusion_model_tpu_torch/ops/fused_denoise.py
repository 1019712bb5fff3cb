"""The whole CFG DDPM chain of one replan as one CUDA kernel, beside its
plain PyTorch version.

Port of ``mpc_via_diffusion_model_tpu/ops/fused_denoise.py::make_fused_cfg_chain``.
``make_fused_cfg_chain`` returns a ``FusedCfgChain``; calling it,
``chain(context, noise) -> u_norm``, launches ``csrc/cfg_chain.cu`` when the
tensors lie on a CUDA device and runs ``FusedCfgChain.plain`` when they lie
on the CPU. On a CUDA tensor it launches the kernel or raises: it never
falls back to the plain version there.

As in the JAX package, the FiLM biases of every (step, ResidualTemporalBlock,
row) depend only on the timestep and the context, so they are computed in
torch ahead of the kernel in one einsum. Conditional rows use the context
and present bit 1, unconditional rows zeros and bit 0.

``noise`` has ``ddpm_cfg_sample``'s layout (n_total + 1, B, H, D): ``[0]``
is x_T and ``[1 + s]`` is injected at step s. The kernel gets it reordered so
that its row ``n_total`` is x_T.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import numpy as np
import torch

from ..core.schedules import DiffusionSchedule
from ..models.layers import mish
from ..models.temporal_unet import TemporalUnet
from ..utils.device import resolve_device
from . import _build
from .unet_pack import M_LEN, PackedUnet, pack_unet

__all__ = ["FusedCfgChain", "make_fused_cfg_chain", "step_coefficients"]


def step_coefficients(schedule: DiffusionSchedule, n_tail: int):
    """Per-step scalars of the chain, (n_total, 5) float64 rows of
    sra, srm, c1, c2, sigma * gate, and the effective timesteps (n_total,),
    built as mpc_via_diffusion_model_tpu/ops/fused_denoise.py:72-86 builds
    them: the noise-free tail clamps t to 0 and gates the noise off."""
    steps = np.arange(schedule.n_steps - 1, -n_tail - 1, -1)
    t_eff = np.maximum(steps, 0)
    tab = lambda a: a.double().numpy()[t_eff]
    sig = np.exp(0.5 * tab(schedule.posterior_log_variance_clipped))
    coefs = np.stack([
        tab(schedule.sqrt_recip_alphas_cumprod), tab(schedule.sqrt_recipm1_alphas_cumprod),
        tab(schedule.posterior_mean_coef1), tab(schedule.posterior_mean_coef2),
        sig * (steps > 0)], axis=1)
    return coefs, t_eff


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The built ``csrc/cfg_chain.cu``, with its C signatures declared."""
    lib = _build.load("cfg_chain")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cfg_chain_launch.argtypes = [p, p, i, p, p, p, p, i, i, ctypes.c_float, ctypes.c_float, p]
    lib.cfg_chain_launch.restype = i
    lib.cfg_chain_error_string.argtypes = [i]
    lib.cfg_chain_error_string.restype = ctypes.c_char_p
    lib.cfg_chain_meta_len.argtypes = []
    lib.cfg_chain_meta_len.restype = i
    if lib.cfg_chain_meta_len() != M_LEN:
        raise RuntimeError("cfg_chain.cu and unet_pack.py disagree on the meta layout")
    return lib


class FusedCfgChain:
    """``chain(context (B, C), noise (n_total+1, B, H, D)) -> u_norm (B, H, D)``.

    ``launches`` counts kernel launches and ``plain_calls`` calls of the
    plain version; callers reset them to 0 to count one run.
    """

    def __init__(self, packed: PackedUnet, schedule: DiffusionSchedule, n_samples: int,
                 w: float, n_tail: int):
        self.packed, self.model = packed, packed.model
        self.n_samples, self.w = n_samples, float(w)
        device = packed.weights.device
        self.n_total = schedule.n_steps + n_tail
        coefs, t_eff = step_coefficients(schedule, n_tail)
        self.coefs = torch.tensor(coefs, dtype=torch.float32, device=device)
        self.t_eff = torch.as_tensor(t_eff, device=device)
        with torch.no_grad():
            self.t_embs = self.model.time_mlp(self.t_eff)  # (n_total, time_emb_dim)
        self.launches = 0
        self.plain_calls = 0

    def _check(self, context: torch.Tensor, noise: torch.Tensor) -> None:
        b, h, d = self.n_samples, self.packed.horizon, self.packed.state_dim
        if tuple(context.shape) != (b, self.model.context_dim):
            raise ValueError(f"context must be ({b}, {self.model.context_dim}), got {tuple(context.shape)}")
        if tuple(noise.shape) != (self.n_total + 1, b, h, d):
            raise ValueError(f"noise must be {(self.n_total + 1, b, h, d)}, got {tuple(noise.shape)}")
        if context.dtype != torch.float32 or noise.dtype != torch.float32:
            raise ValueError("context and noise must be float32")
        if context.device != noise.device:
            raise ValueError("context and noise must lie on one device")

    def films(self, context: torch.Tensor) -> torch.Tensor:
        """(n_total, n_res, 2B, max_c) FiLM biases of the doubled batch."""
        b, n = context.shape[0], self.n_total
        ctx2 = torch.cat([context, torch.zeros_like(context)], dim=0)
        parts = [self.t_embs[:, None, :].expand(n, 2 * b, self.t_embs.shape[-1]),
                 ctx2[None].expand(n, 2 * b, ctx2.shape[-1])]
        if self.model.cfg_indicator:
            present = torch.cat([torch.ones((b, 1), device=context.device),
                                 torch.zeros((b, 1), device=context.device)])
            parts.append(present[None].expand(n, 2 * b, 1))
        c_emb = torch.cat(parts, dim=-1)
        return (torch.einsum("sbc,rcd->srbd", mish(c_emb), self.packed.films_w)
                + self.packed.films_b[None, :, None, :])

    def __call__(self, context: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        if context.device.type == "cpu":
            return self.plain(context, noise)
        return self.kernel(context, noise)

    @torch.no_grad()
    def kernel(self, context: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Launch ``csrc/cfg_chain.cu`` on the current stream."""
        self._check(context, noise)
        if not context.is_cuda or context.device != self.packed.weights.device:
            raise ValueError("the cfg_chain kernel takes tensors on the packed weights' CUDA device")
        films = self.films(context).contiguous()
        noise_tab = torch.cat([noise[1:], noise[:1]], dim=0).contiguous()
        out = torch.empty((self.n_samples, self.packed.horizon, self.packed.state_dim),
                          dtype=torch.float32, device=context.device)
        lib = _kernel_lib()
        err = lib.cfg_chain_launch(
            self.packed.weights.data_ptr(), self.packed.meta.data_ptr(), self.packed.smem_bytes,
            films.data_ptr(), noise_tab.data_ptr(), self.coefs.data_ptr(), out.data_ptr(),
            self.n_total, self.n_samples, self.w, float(np.float32(1.0 + self.w)),
            torch.cuda.current_stream(context.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"cfg_chain launch failed: {lib.cfg_chain_error_string(err).decode()}")
        self.launches += 1
        return out

    @torch.no_grad()
    def plain(self, context: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The same chain in plain PyTorch: ``TemporalUnet.forward`` on the
        doubled batch at every step, then the kernel's per-step arithmetic
        in the same order (mpc_via_diffusion_model_tpu/ops/fused_denoise.py:114-120)."""
        self._check(context, noise)
        self.plain_calls += 1
        b = self.n_samples
        ctx2 = torch.cat([context, context], dim=0)
        mask2 = torch.cat([torch.zeros((b, 1), device=context.device),
                           torch.ones((b, 1), device=context.device)])
        x = noise[0]
        for si in range(self.n_total):
            sra, srm, c1, c2, sg = self.coefs[si]
            x2 = torch.cat([x, x], dim=0)
            eps2 = self.model(x2, self.t_eff[si].expand(2 * b), ctx2, mask2)
            recon2 = sra * x2 - srm * eps2
            recon = torch.clamp((1.0 + self.w) * recon2[:b] - self.w * recon2[b:], -1.0, 1.0)
            x = c1 * recon + c2 * x + sg * noise[si + 1]
        return x


def make_fused_cfg_chain(model_or_packed: Union[TemporalUnet, PackedUnet],
                         schedule: DiffusionSchedule, n_samples: int = 1, w: float = 0.01,
                         n_tail: int = 5, device=None) -> FusedCfgChain:
    """Build the CFG chain of one replan on ``device`` (``cuda`` unless
    given). A ``TemporalUnet`` is moved to the device and packed."""
    dev = resolve_device(device)
    if isinstance(model_or_packed, PackedUnet):
        packed = model_or_packed
        if packed.weights.device.type != dev.type:
            raise ValueError(f"the packed U-Net lies on {packed.weights.device}, not {dev}")
    else:
        packed = pack_unet(model_or_packed.to(dev).eval(), dev)
    return FusedCfgChain(packed, schedule, n_samples, w, n_tail)
