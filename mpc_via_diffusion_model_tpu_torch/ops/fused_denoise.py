"""The sampling chain of one replan as one CUDA kernel, beside its plain
PyTorch version: the CFG DDPM chain of the flagship, and the distilled
student's DDIM chain.

Port of ``make_fused_cfg_chain`` and ``make_fused_ddim_chain`` of
``mpc_via_diffusion_model_tpu/ops/fused_denoise.py``. Each returns a wrapper
(``FusedCfgChain``, ``FusedDdimChain``); calling it launches its kernel
(``csrc/cfg_chain.cu``, ``csrc/ddim_chain.cu``) when the tensors lie on a
CUDA device and runs its ``plain`` version when they lie on the CPU. On a
CUDA tensor it launches the kernel or raises: it never falls back to the
plain version there.

Both kernels run each sample on a thread-block cluster of 8 CTAs that
splits the U-Net body by output channel, one GroupNorm group per CTA
(``csrc/unet_body_cluster.cuh``), as the episodes do: the CFG chain on the
sample's two row-sets, the DDIM chain on its one. They need a card with
clusters (sm_90) and a model whose convs and GroupNorms
``unet_pack.cluster_split`` accepts. Both are checked where the kernel
would be launched (``_build.ClusterLaunch``), so the plain versions on
the CPU take any model.

As in the JAX package, the FiLM biases of every (step, ResidualTemporalBlock,
row) depend only on the timestep and the context, so they are computed in
torch ahead of the kernel in one einsum. The CFG chain's conditional rows use
the context and present bit 1, its unconditional rows zeros and bit 0; the
student's one row-set per sample is conditional.

The CFG chain's ``noise`` has ``ddpm_cfg_sample``'s layout (n_total + 1, B,
H, D): ``[0]`` is x_T and ``[1 + s]`` is injected at step s. The kernel gets
it reordered so that its row ``n_total`` is x_T. The DDIM chain is
deterministic: its only noise is its initial draw ``x_init`` (B, H, D).

The CFG chain takes the JAX builder's ``weights_dtype``: float32, or
bfloat16, which launches the kernel's bf16 entry (``cfg_chain_bf16``: conv
kernels read as bf16, every product's activation operand rounded to bf16)
and gives ``plain`` the U-Net of ``models/bf16.py``. The DDIM chain takes
float32 only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..core.schedules import DiffusionSchedule
from ..diffusion.distillation import ddim_affine_coefs, make_student_ddim_sampler
from ..models.bf16 import bf16_conv_copy
from ..models.layers import mish
from ..models.temporal_unet import TemporalUnet
from . import _build
from .unet_pack import CLUSTER, M_LEN, PackedUnet, packed_on

__all__ = ["FusedCfgChain", "FusedDdimChain", "make_fused_cfg_chain", "make_fused_ddim_chain",
           "step_coefficients", "ddim_step_coefficients", "film_table", "is_bf16",
           "cfg_chain_max_active_clusters", "cfg_chain_bf16_max_active_clusters",
           "ddim_chain_max_active_clusters"]


def is_bf16(weights_dtype) -> bool:
    """Whether the CFG kernels' ``weights_dtype`` is bfloat16; raises
    ``NotImplementedError`` for a type other than float32 and bfloat16."""
    if weights_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"the CFG kernels take float32 or bfloat16 weights, not "
                                  f"{weights_dtype}")
    return weights_dtype == torch.bfloat16


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


def ddim_step_coefficients(schedule: DiffusionSchedule, times: Sequence[int]):
    """Per-step scalars of the student's chain over ``times``: (n_total, 4)
    float32 rows of sra, srm, c1, c2 (``ddim_affine_coefs``, as
    mpc_via_diffusion_model_tpu/ops/fused_denoise.py:187-191 stacks them) and
    the eval timesteps (n_total,) int64."""
    tab = ddim_affine_coefs(schedule, times)
    coefs = np.stack([tab["sra"], tab["srm"], tab["c1"], tab["c2"]], axis=1)
    return coefs, tab["t"].astype(np.int64)


def film_table(packed: PackedUnet, t_embs: torch.Tensor, context: torch.Tensor,
               bit: torch.Tensor) -> torch.Tensor:
    """(n_total, n_res, B, max_c) FiLM biases ``mish(c) @ Wf_r + bf_r`` of
    c = [t_emb of the step, context row, present bit of the row] for every
    step (``t_embs`` (n_total, temb)) and row (``context`` (B, C), ``bit``
    (B, 1)); the bit is left out for models without ``cfg_indicator``."""
    n, b = t_embs.shape[0], context.shape[0]
    parts = [t_embs[:, None, :].expand(n, b, t_embs.shape[-1]),
             context[None].expand(n, b, context.shape[-1])]
    if packed.model.cfg_indicator:
        parts.append(bit[None].expand(n, b, 1))
    c_emb = torch.cat(parts, dim=-1)
    return (torch.einsum("sbc,rcd->srbd", mish(c_emb), packed.films_w)
            + packed.films_b[None, :, None, :])


@functools.lru_cache(maxsize=None)
def _cfg_lib() -> ctypes.CDLL:
    """The built ``csrc/cfg_chain.cu``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind("cfg_chain", [p, p, i, p, p, p, p, i, i, f, f, p], M_LEN, cluster=CLUSTER)


def cfg_chain_max_active_clusters(smem_bytes: int) -> int:
    """How many clusters of the CFG chain kernel (one per sample) fit on the
    current CUDA device at once with ``smem_bytes`` of dynamic shared memory
    per CTA (``cudaOccupancyMaxActiveClusters``); raises with CUDA's text
    when the query fails. Builds the kernel first if needed."""
    return _build.max_active_clusters(_cfg_lib(), "cfg_chain", smem_bytes)


@functools.lru_cache(maxsize=None)
def _cfg_bf16_lib() -> ctypes.CDLL:
    """The built ``csrc/cfg_chain.cu``, its bf16 entry declared."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind("cfg_chain_bf16", [p, p, p, i, p, p, p, p, i, i, f, f, p], M_LEN,
                       cluster=CLUSTER, source="cfg_chain")


def cfg_chain_bf16_max_active_clusters(smem_bytes: int) -> int:
    """The same query for the chain kernel's bf16 instantiation."""
    return _build.max_active_clusters(_cfg_bf16_lib(), "cfg_chain_bf16", smem_bytes)


@functools.lru_cache(maxsize=None)
def _ddim_lib() -> ctypes.CDLL:
    """The built ``csrc/ddim_chain.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("ddim_chain", [p, p, i, p, p, p, p, i, i, p], M_LEN, cluster=CLUSTER)


def ddim_chain_max_active_clusters(smem_bytes: int) -> int:
    """How many clusters of the DDIM chain kernel (one per sample) fit on
    the current CUDA device at once with ``smem_bytes`` of dynamic shared
    memory per CTA (``cudaOccupancyMaxActiveClusters``); raises with CUDA's
    text when the query fails. Builds the kernel first if needed."""
    return _build.max_active_clusters(_ddim_lib(), "ddim_chain", smem_bytes)


class FusedCfgChain:
    """``chain(context (B, C), noise (n_total+1, B, H, D)) -> u_norm (B, H, D)``.

    ``launches`` counts kernel launches and ``plain_calls`` calls of the
    plain version; callers reset them to 0 to count one run. ``cluster``
    holds the rank-major weights the kernel reads and its occupancy check.
    With ``weights_dtype`` bfloat16 it launches the bf16 entry
    (``entry``), and ``plain`` runs ``plain_model``, the U-Net with bf16
    convs (``models/bf16.py``).
    """

    def __init__(self, packed: PackedUnet, schedule: DiffusionSchedule, n_samples: int,
                 w: float, n_tail: int, weights_dtype=torch.float32):
        self.packed, self.model = packed, packed.model
        self.bf16 = is_bf16(weights_dtype)
        self.plain_model = bf16_conv_copy(self.model) if self.bf16 else self.model
        self.n_samples, self.w = n_samples, float(w)
        device = packed.weights.device
        self.n_total = schedule.n_steps + n_tail
        coefs, t_eff = step_coefficients(schedule, n_tail)
        self.coefs = torch.tensor(coefs, dtype=torch.float32, device=device)
        self.t_eff = torch.as_tensor(t_eff, device=device)
        with torch.no_grad():
            self.t_embs = self.model.time_mlp(self.t_eff)  # (n_total, time_emb_dim)
        self.entry = "cfg_chain_bf16" if self.bf16 else "cfg_chain"
        self.cluster = _build.ClusterLaunch(
            packed, self.entry,
            cfg_chain_bf16_max_active_clusters if self.bf16 else cfg_chain_max_active_clusters)
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
        b = context.shape[0]
        ctx2 = torch.cat([context, torch.zeros_like(context)], dim=0)
        present = torch.cat([torch.ones((b, 1), device=context.device),
                             torch.zeros((b, 1), device=context.device)])
        return film_table(self.packed, self.t_embs, ctx2, present)

    def __call__(self, context: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        if context.device.type == "cpu":
            return self.plain(context, noise)
        return self.kernel(context, noise)

    @torch.no_grad()
    def kernel(self, context: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Launch ``csrc/cfg_chain.cu`` (its bf16 entry for bf16 weights),
        one cluster of 8 CTAs per sample, on the current stream; raises when
        the body cannot be split over the cluster or no cluster fits on the
        card."""
        self._check(context, noise)
        if not context.is_cuda or context.device != self.packed.weights.device:
            raise ValueError(f"the {self.entry} kernel takes tensors on the packed weights' CUDA "
                             "device")
        weights = [self.cluster.weights] + ([self.cluster.weights_bf16] if self.bf16 else [])
        self.cluster.require_fit(self.packed.smem_bytes, context.device)
        films = self.films(context).contiguous()
        noise_tab = torch.cat([noise[1:], noise[:1]], dim=0).contiguous()
        out = torch.empty((self.n_samples, self.packed.horizon, self.packed.state_dim),
                          dtype=torch.float32, device=context.device)
        _build.launch(
            _cfg_bf16_lib() if self.bf16 else _cfg_lib(), self.entry,
            *(wt.data_ptr() for wt in weights), self.packed.meta.data_ptr(),
            self.packed.smem_bytes, films.data_ptr(), noise_tab.data_ptr(), self.coefs.data_ptr(),
            out.data_ptr(), self.n_total, self.n_samples, self.w, float(np.float32(1.0 + self.w)),
            torch.cuda.current_stream(context.device).cuda_stream)
        self.launches += 1
        return out

    @torch.no_grad()
    def plain(self, context: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The same chain in plain PyTorch: ``TemporalUnet.forward`` on the
        doubled batch at every step (``plain_model``'s), then the kernel's
        per-step arithmetic in the same order
        (mpc_via_diffusion_model_tpu/ops/fused_denoise.py:114-120)."""
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
            eps2 = self.plain_model(x2, self.t_eff[si].expand(2 * b), ctx2, mask2)
            recon2 = sra * x2 - srm * eps2
            recon = torch.clamp((1.0 + self.w) * recon2[:b] - self.w * recon2[b:], -1.0, 1.0)
            x = c1 * recon + c2 * x + sg * noise[si + 1]
        return x


def make_fused_cfg_chain(model_or_packed: Union[TemporalUnet, PackedUnet],
                         schedule: DiffusionSchedule, n_samples: int = 1, w: float = 0.01,
                         n_tail: int = 5, weights_dtype=torch.float32,
                         device=None) -> FusedCfgChain:
    """Build the CFG chain of one replan on ``device`` (``cuda`` unless
    given), with float32 or bfloat16 conv weights (``weights_dtype``; any
    other type raises ``NotImplementedError``). A ``TemporalUnet`` is moved
    to the device and packed."""
    is_bf16(weights_dtype)
    return FusedCfgChain(packed_on(model_or_packed, device), schedule, n_samples, w, n_tail,
                         weights_dtype)


class FusedDdimChain:
    """``chain(context (B, C), x_init (B, H, D)) -> u_norm (B, H, D)``: a
    distilled student's deterministic DDIM chain over its times grid.

    ``noise_shape`` is (B, H, D), the x_init of one replan:
    ``make_closed_loop`` stages its noise in that layout when this chain is
    its ``sample_override``. ``launches`` counts kernel launches and
    ``plain_calls`` calls of the plain version; callers reset them to 0 to
    count one run. ``cluster`` holds the rank-major weights the kernel reads
    and its occupancy check.
    """

    def __init__(self, packed: PackedUnet, schedule: DiffusionSchedule, times: Sequence[int],
                 n_samples: int):
        self.packed, self.model = packed, packed.model
        self.n_samples = int(n_samples)
        device = packed.weights.device
        coefs, t_eval = ddim_step_coefficients(schedule, times)
        self.n_total = len(t_eval)
        self.coefs = torch.from_numpy(coefs).to(device)
        self.t_eval = torch.from_numpy(t_eval).to(device)
        with torch.no_grad():
            self.t_embs = self.model.time_mlp(self.t_eval)  # (n_total, time_emb_dim)
        self._sample = make_student_ddim_sampler(schedule, self.model, times)
        self.cluster = _build.ClusterLaunch(packed, "ddim_chain", ddim_chain_max_active_clusters)
        self.launches = 0
        self.plain_calls = 0

    @property
    def noise_shape(self) -> Tuple[int, ...]:
        return (self.n_samples, self.packed.horizon, self.packed.state_dim)

    def _check(self, context: torch.Tensor, x_init: torch.Tensor) -> None:
        b = self.n_samples
        if tuple(context.shape) != (b, self.model.context_dim):
            raise ValueError(f"context must be ({b}, {self.model.context_dim}), got {tuple(context.shape)}")
        if tuple(x_init.shape) != self.noise_shape:
            raise ValueError(f"x_init must be {self.noise_shape}, got {tuple(x_init.shape)}")
        if context.dtype != torch.float32 or x_init.dtype != torch.float32:
            raise ValueError("context and x_init must be float32")
        if context.device != x_init.device:
            raise ValueError("context and x_init must lie on one device")

    def films(self, context: torch.Tensor) -> torch.Tensor:
        """(n_total, n_res, B, max_c) FiLM biases of the conditional rows."""
        return film_table(self.packed, self.t_embs, context,
                          torch.ones((context.shape[0], 1), device=context.device))

    def __call__(self, context: torch.Tensor, x_init: torch.Tensor) -> torch.Tensor:
        if context.device.type == "cpu":
            return self.plain(context, x_init)
        return self.kernel(context, x_init)

    @torch.no_grad()
    def kernel(self, context: torch.Tensor, x_init: torch.Tensor) -> torch.Tensor:
        """Launch ``csrc/ddim_chain.cu``, one cluster of 8 CTAs per sample, on
        the current stream; raises when the body cannot be split over the
        cluster or no cluster fits on the card."""
        self._check(context, x_init)
        if not context.is_cuda or context.device != self.packed.weights.device:
            raise ValueError("the ddim_chain kernel takes tensors on the packed weights' CUDA device")
        weights = self.cluster.weights
        self.cluster.require_fit(self.packed.smem_bytes, context.device)
        out = torch.empty(self.noise_shape, dtype=torch.float32, device=context.device)
        self._launch(weights, self.films(context).contiguous(), x_init.contiguous(), out)
        return out

    def _launch(self, weights: torch.Tensor, films: torch.Tensor, x_init: torch.Tensor,
                out: torch.Tensor) -> None:
        """The launch alone, on ``kernel``'s checked and prepared tensors:
        the rank-major weights, films (n_total, n_res, B, max_c), x_init and
        out (B, H, D)."""
        _build.launch(
            _ddim_lib(), "ddim_chain",
            weights.data_ptr(), self.packed.meta.data_ptr(), self.packed.smem_bytes,
            films.data_ptr(), x_init.data_ptr(), self.coefs.data_ptr(), out.data_ptr(),
            self.n_total, self.n_samples, torch.cuda.current_stream(out.device).cuda_stream)
        self.launches += 1

    @torch.no_grad()
    def plain(self, context: torch.Tensor, x_init: torch.Tensor) -> torch.Tensor:
        """The same chain in plain PyTorch: ``make_student_ddim_sampler``
        with the ``TemporalUnet``, in the kernel's order of arithmetic."""
        self._check(context, x_init)
        self.plain_calls += 1
        return self._sample(context, x_init)


def make_fused_ddim_chain(model_or_packed: Union[TemporalUnet, PackedUnet],
                          schedule: DiffusionSchedule, times: Sequence[int], n_samples: int = 1,
                          weights_dtype=torch.float32, clip_denoised: bool = True,
                          device=None) -> FusedDdimChain:
    """Build a distilled student's DDIM chain of one replan over ``times``
    on ``device`` (``cuda`` unless given). A ``TemporalUnet`` is moved to the
    device and packed. Raises ``NotImplementedError`` for the options of the
    JAX function that the kernel does not run: bf16 weights and ``clip_denoised=False``."""
    refuse_unported_ddim_options(weights_dtype, clip_denoised)
    return FusedDdimChain(packed_on(model_or_packed, device), schedule, times, n_samples)


def refuse_unported_ddim_options(weights_dtype, clip_denoised: bool) -> None:
    """Raises ``NotImplementedError`` for the options of the JAX DDIM
    functions that the DDIM kernels do not run."""
    if weights_dtype != torch.float32:
        raise NotImplementedError(f"the DDIM kernels take float32 weights, not {weights_dtype}")
    if not clip_denoised:
        raise NotImplementedError("the DDIM kernels clip the reconstruction; clip_denoised=False "
                                  "is not ported")
