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
sample's two row-sets, the DDIM chain on its one, each on the plan of
shared memory for its row-sets (``unet_pack``, ``metas``). They need a card
with clusters (sm_90) and a model whose convs and GroupNorms
``unet_pack.cluster_split`` accepts. Both are checked where the kernel
would be launched (``_build.ClusterLaunch``), so the plain versions on
the CPU take any model. The DDIM chain's plan is checked there too. The
CFG chain's plan is chosen when it is built, once, by shape
(``cfg_plan``): the two-row-set plan where it fits one block, as for every
cart-pole and quadrotor model, else the plan in turns (``unet_pack.TURNS``:
the conditional and unconditional passes one after the other on one
row-set; 158,348 B per CTA at the panda arm's horizon 128, where two
row-sets need 304,780 B), each with entries of its own (``CFG_CHAIN_ENTRIES``);
where neither fits it raises ``ValueError``. The wrapper records the choice
(``plan``, ``entry``); nothing falls back to another plan at launch.

As in the JAX package, the FiLM biases of every (step, ResidualTemporalBlock,
row) depend only on the timestep and the context, so they are computed in
torch ahead of the kernel in one einsum. The CFG chain's conditional rows use
the context and present bit 1, its unconditional rows zeros and bit 0; the
student's one row-set per sample is conditional.

The CFG chain's ``noise`` has ``ddpm_cfg_sample``'s layout (n_total + 1, B,
H, D): ``[0]`` is x_T and ``[1 + s]`` is injected at step s. The kernel gets
it reordered so that its row ``n_total`` is x_T. The DDIM chain is
deterministic: its only noise is its initial draw ``x_init`` (B, H, D).

Both chains take the JAX builders' ``weights_dtype``: float32, or
bfloat16, which launches the kernel's bf16 entry (the CFG chain's of its
plan, ``cfg_chain_bf16`` or ``cfg_chain_turns_bf16`` of
``csrc/cfg_chain_turns.cu``; the DDIM chain's ``ddim_chain_bf16``: conv
kernels and the final 1x1 conv read as bf16, every product's activation
operand rounded to bf16) and gives ``plain`` the U-Net of
``models/bf16.py``. Both take ``clip_denoised`` (True by default, as in
JAX): False leaves each x0 reconstruction unclipped, a runtime argument of
every entry.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.schedules import DiffusionSchedule
from ..diffusion.distillation import ddim_affine_coefs, make_student_ddim_sampler
from ..models.bf16 import bf16_conv_copy
from ..models.layers import mish
from ..models.temporal_unet import TemporalUnet
from . import _build
from .unet_pack import CLUSTER, M_LEN, SMEM_LIMIT, TURNS, PackedUnet, Plan, packed_on

__all__ = ["FusedCfgChain", "FusedDdimChain", "make_fused_cfg_chain", "make_fused_ddim_chain",
           "step_coefficients", "ddim_step_coefficients", "film_table", "is_bf16",
           "cfg_chain_max_active_clusters", "cfg_chain_bf16_max_active_clusters",
           "ddim_chain_max_active_clusters", "cfg_plan", "CFG_CHAIN_ENTRIES", "CFG_CHAIN_PLANS"]

# the CFG chain's entry for each (plan, bf16 weights): csrc/cfg_chain.cu's instantiations
CFG_CHAIN_ENTRIES = {(2, False): "cfg_chain", (2, True): "cfg_chain_bf16",
                     (TURNS, False): "cfg_chain_turns", (TURNS, True): "cfg_chain_turns_bf16"}
CFG_CHAIN_PLANS = (2, TURNS)  # the plans the chain runs, in the order cfg_plan tries them


def cfg_plan(smem_of: Callable[[Plan], int], what: str,
             plans: Sequence[Plan] = CFG_CHAIN_PLANS) -> Tuple[Plan, int]:
    """The plan a CFG kernel launches with, chosen once by shape: the first
    of ``plans`` (the chain's: the two-row-set plan before the plan in
    turns; an episode entry's: the one plan it was compiled for) whose
    shared memory per CTA, ``smem_of(plan)``, fits one block, and that many
    bytes. Raises ``ValueError`` naming each plan's bytes and the limit
    where none fits."""
    sizes = {plan: int(smem_of(plan)) for plan in plans}
    for plan, n in sizes.items():
        if n <= SMEM_LIMIT:
            return plan, n
    raise ValueError(f"the {what} needs " + ", ".join(
        f"{n} B of shared memory per CTA on the plan {plan!r}" for plan, n in sizes.items())
        + f", over the {SMEM_LIMIT} B a block may take")


def is_bf16(weights_dtype) -> bool:
    """Whether the kernels' ``weights_dtype`` is bfloat16; raises
    ``NotImplementedError`` for a type other than float32 and bfloat16."""
    if weights_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"the kernels take float32 or bfloat16 weights, not "
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
def _cfg_lib(entry: str = "cfg_chain") -> ctypes.CDLL:
    """The built ``csrc/cfg_chain.cu`` (the entries in turns:
    ``csrc/cfg_chain_turns.cu``), ``entry`` (``CFG_CHAIN_ENTRIES``) declared;
    a bf16 entry takes the bf16 copy of the weights second."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    weights = [p, p] if entry.endswith("_bf16") else [p]
    source = "cfg_chain_turns" if "_turns" in entry else "cfg_chain"
    return _build.bind(entry, [*weights, p, i, p, p, p, p, i, i, f, f, i, p], M_LEN,
                       cluster=CLUSTER, source=source)


def cfg_chain_max_active_clusters(smem_bytes: int, entry: str = "cfg_chain") -> int:
    """How many clusters of the CFG chain kernel's ``entry`` (one per
    sample) fit on the current CUDA device at once with ``smem_bytes`` of
    dynamic shared memory per CTA (``cudaOccupancyMaxActiveClusters``);
    raises with CUDA's text when the query fails. Builds the kernel first if
    needed."""
    return _build.max_active_clusters(_cfg_lib(entry), entry, smem_bytes)


def cfg_chain_bf16_max_active_clusters(smem_bytes: int) -> int:
    """The same query for the chain kernel's bf16 instantiation."""
    return cfg_chain_max_active_clusters(smem_bytes, "cfg_chain_bf16")


@functools.lru_cache(maxsize=None)
def _ddim_lib(entry: str = "ddim_chain") -> ctypes.CDLL:
    """The built ``csrc/ddim_chain.cu``, ``entry`` declared (``ddim_chain``,
    or ``ddim_chain_bf16``, which takes the bf16 copy of the weights
    second)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    weights = [p, p] if entry.endswith("_bf16") else [p]
    return _build.bind(entry, [*weights, p, i, p, p, p, p, i, i, i, p], M_LEN, cluster=CLUSTER,
                       source="ddim_chain")


def ddim_chain_max_active_clusters(smem_bytes: int, entry: str = "ddim_chain") -> int:
    """How many clusters of the DDIM chain kernel's ``entry`` (one per
    sample) fit on the current CUDA device at once with ``smem_bytes`` of
    dynamic shared memory per CTA (``cudaOccupancyMaxActiveClusters``);
    raises with CUDA's text when the query fails. Builds the kernel first if
    needed."""
    return _build.max_active_clusters(_ddim_lib(entry), entry, smem_bytes)


class FusedCfgChain:
    """``chain(context (B, C), noise (n_total+1, B, H, D)) -> u_norm (B, H, D)``.

    ``launches`` counts kernel launches and ``plain_calls`` calls of the
    plain version; callers reset them to 0 to count one run. ``cluster``
    holds the rank-major weights the kernel reads and its occupancy check.
    ``plan`` is the plan of shared memory ``cfg_plan`` chose (two row-sets,
    else in turns; a subclass that sets ``_plans`` to ``(TURNS,)`` runs in
    turns at any shape, as the checks of the two entries against each other
    do) and ``entry`` the kernel's entry
    for it (``CFG_CHAIN_ENTRIES``); with ``weights_dtype`` bfloat16 that is
    the plan's bf16 entry, and ``plain`` runs ``plain_model``, the U-Net
    with bf16 convs (``models/bf16.py``). ``clip_denoised`` False leaves the
    CFG reconstruction unclipped in both.
    """

    _plans: Sequence[Plan] = CFG_CHAIN_PLANS

    def __init__(self, packed: PackedUnet, schedule: DiffusionSchedule, n_samples: int,
                 w: float, n_tail: int, weights_dtype=torch.float32, clip_denoised: bool = True):
        self.packed, self.model = packed, packed.model
        self.bf16 = is_bf16(weights_dtype)
        self.clip_denoised = bool(clip_denoised)
        self.plain_model = bf16_conv_copy(self.model) if self.bf16 else self.model
        self.n_samples, self.w = n_samples, float(w)
        device = packed.weights.device
        self.n_total = schedule.n_steps + n_tail
        coefs, t_eff = step_coefficients(schedule, n_tail)
        self.coefs = torch.tensor(coefs, dtype=torch.float32, device=device)
        self.t_eff = torch.as_tensor(t_eff, device=device)
        with torch.no_grad():
            self.t_embs = self.model.time_mlp(self.t_eff)  # (n_total, time_emb_dim)
        # the plan: the meta table the kernel reads and its shared memory per CTA
        self.plan, self.smem_bytes = cfg_plan(packed.chain_smem_bytes, "CFG chain kernel",
                                              self._plans)
        self.meta = packed.metas[self.plan]
        self.entry = CFG_CHAIN_ENTRIES[self.plan, self.bf16]
        self.cluster = _build.ClusterLaunch(
            packed, self.entry, functools.partial(cfg_chain_max_active_clusters, entry=self.entry))
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
        """Launch ``csrc/cfg_chain.cu``'s ``entry`` (its plan's, bf16 for
        bf16 weights), one cluster of 8 CTAs per sample, on the current
        stream; raises when the body cannot be split over the cluster or no
        cluster fits on the card."""
        self._check(context, noise)
        if not context.is_cuda or context.device != self.packed.weights.device:
            raise ValueError(f"the {self.entry} kernel takes tensors on the packed weights' CUDA "
                             "device")
        weights = [self.cluster.weights] + ([self.cluster.weights_bf16] if self.bf16 else [])
        self.cluster.require_fit(self.smem_bytes, context.device)
        films = self.films(context).contiguous()
        noise_tab = torch.cat([noise[1:], noise[:1]], dim=0).contiguous()
        out = torch.empty((self.n_samples, self.packed.horizon, self.packed.state_dim),
                          dtype=torch.float32, device=context.device)
        _build.launch(
            _cfg_lib(self.entry), self.entry,
            *(wt.data_ptr() for wt in weights), self.meta.data_ptr(),
            self.smem_bytes, films.data_ptr(), noise_tab.data_ptr(), self.coefs.data_ptr(),
            out.data_ptr(), self.n_total, self.n_samples, self.w, float(np.float32(1.0 + self.w)),
            int(self.clip_denoised), torch.cuda.current_stream(context.device).cuda_stream)
        self.launches += 1
        return out

    @torch.no_grad()
    def plain(self, context: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The same chain in plain PyTorch: ``TemporalUnet.forward`` on the
        doubled batch at every step (``plain_model``'s), then the kernel's
        per-step arithmetic in the same order
        (mpc_via_diffusion_model_tpu/ops/fused_denoise.py:114-120), the
        clip with ``clip_denoised`` only."""
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
            recon = (1.0 + self.w) * recon2[:b] - self.w * recon2[b:]
            if self.clip_denoised:
                recon = torch.clamp(recon, -1.0, 1.0)
            x = c1 * recon + c2 * x + sg * noise[si + 1]
        return x


def make_fused_cfg_chain(model_or_packed: Union[TemporalUnet, PackedUnet],
                         schedule: DiffusionSchedule, n_samples: int = 1, w: float = 0.01,
                         n_tail: int = 5, weights_dtype=torch.float32,
                         clip_denoised: bool = True, device=None) -> FusedCfgChain:
    """Build the CFG chain of one replan on ``device`` (``cuda`` unless
    given), with float32 or bfloat16 conv weights (``weights_dtype``; any
    other type raises ``NotImplementedError``); ``clip_denoised`` False
    leaves the reconstruction unclipped. A ``TemporalUnet`` is moved to the
    device and packed. The plan is the first that fits one block
    (``cfg_plan``: two row-sets, else in turns); raises ``ValueError`` where
    none fits."""
    is_bf16(weights_dtype)
    return FusedCfgChain(packed_on(model_or_packed, device), schedule, n_samples, w, n_tail,
                         weights_dtype, clip_denoised)


class FusedDdimChain:
    """``chain(context (B, C), x_init (B, H, D)) -> u_norm (B, H, D)``: a
    distilled student's deterministic DDIM chain over its times grid.

    ``noise_shape`` is (B, H, D), the x_init of one replan:
    ``make_closed_loop`` stages its noise in that layout when this chain is
    its ``sample_override``. ``launches`` counts kernel launches and
    ``plain_calls`` calls of the plain version; callers reset them to 0 to
    count one run. ``cluster`` holds the rank-major weights the kernel reads
    and its occupancy check. ``entry`` is the kernel's entry:
    ``ddim_chain_bf16`` for bf16 weights, whose ``plain`` runs
    ``plain_model``, the U-Net with bf16 convs (``models/bf16.py``).
    ``clip_denoised`` False leaves each reconstruction unclipped in both.
    """

    def __init__(self, packed: PackedUnet, schedule: DiffusionSchedule, times: Sequence[int],
                 n_samples: int, weights_dtype=torch.float32, clip_denoised: bool = True):
        self.packed, self.model = packed, packed.model
        self.n_samples = int(n_samples)
        self.bf16 = is_bf16(weights_dtype)
        self.plain_model = bf16_conv_copy(self.model) if self.bf16 else self.model
        self.clip_denoised = bool(clip_denoised)
        self.entry = "ddim_chain_bf16" if self.bf16 else "ddim_chain"
        device = packed.weights.device
        coefs, t_eval = ddim_step_coefficients(schedule, times)
        self.n_total = len(t_eval)
        self.coefs = torch.from_numpy(coefs).to(device)
        self.t_eval = torch.from_numpy(t_eval).to(device)
        with torch.no_grad():
            self.t_embs = self.model.time_mlp(self.t_eval)  # (n_total, time_emb_dim)
        self._sample = make_student_ddim_sampler(schedule, self.plain_model, times,
                                                 self.clip_denoised)
        # the one-row-set plan: the meta table the kernel reads and its shared memory per CTA
        self.meta, self.smem_bytes = packed.metas[1], packed.chain_smem_bytes(1)
        self.cluster = _build.ClusterLaunch(
            packed, self.entry, functools.partial(ddim_chain_max_active_clusters, entry=self.entry))
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
        """Launch ``csrc/ddim_chain.cu``'s ``entry``, one cluster of 8 CTAs per
        sample, on the current stream; raises when the body cannot be split
        over the cluster, its plan is more than a block may take or no
        cluster fits on the card."""
        self._check(context, x_init)
        if not context.is_cuda or context.device != self.packed.weights.device:
            raise ValueError(f"the {self.entry} kernel takes tensors on the packed weights' CUDA "
                             "device")
        weights = self.cluster.weights
        self.cluster.require_fit(self.smem_bytes, context.device)
        out = torch.empty(self.noise_shape, dtype=torch.float32, device=context.device)
        self._launch(weights, self.films(context).contiguous(), x_init.contiguous(), out)
        return out

    def _launch(self, weights: torch.Tensor, films: torch.Tensor, x_init: torch.Tensor,
                out: torch.Tensor) -> None:
        """The launch alone, on ``kernel``'s checked and prepared tensors:
        the rank-major weights (the bf16 entry also reads their bf16 copy,
        ``cluster.weights_bf16``), films (n_total, n_res, B, max_c), x_init
        and out (B, H, D)."""
        bf16 = [self.cluster.weights_bf16.data_ptr()] if self.bf16 else []
        _build.launch(
            _ddim_lib(self.entry), self.entry,
            weights.data_ptr(), *bf16, self.meta.data_ptr(), self.smem_bytes,
            films.data_ptr(), x_init.data_ptr(), self.coefs.data_ptr(), out.data_ptr(),
            self.n_total, self.n_samples, int(self.clip_denoised),
            torch.cuda.current_stream(out.device).cuda_stream)
        self.launches += 1

    @torch.no_grad()
    def plain(self, context: torch.Tensor, x_init: torch.Tensor) -> torch.Tensor:
        """The same chain in plain PyTorch: ``make_student_ddim_sampler``
        with ``plain_model``, in the kernel's order of arithmetic."""
        self._check(context, x_init)
        self.plain_calls += 1
        return self._sample(context, x_init)


def make_fused_ddim_chain(model_or_packed: Union[TemporalUnet, PackedUnet],
                          schedule: DiffusionSchedule, times: Sequence[int], n_samples: int = 1,
                          weights_dtype=torch.float32, clip_denoised: bool = True,
                          device=None) -> FusedDdimChain:
    """Build a distilled student's DDIM chain of one replan over ``times``
    on ``device`` (``cuda`` unless given), with float32 or bfloat16 weights
    (``weights_dtype``; any other type raises ``NotImplementedError``);
    ``clip_denoised`` False leaves each reconstruction unclipped. A
    ``TemporalUnet`` is moved to the device and packed."""
    is_bf16(weights_dtype)
    return FusedDdimChain(packed_on(model_or_packed, device), schedule, times, n_samples,
                          weights_dtype, clip_denoised)
