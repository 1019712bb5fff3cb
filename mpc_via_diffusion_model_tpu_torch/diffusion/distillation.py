"""The sampler half of progressive distillation: port of the time grids, the
affine DDIM tables and ``make_student_ddim_sampler`` of
``mpc_via_diffusion_model_tpu/diffusion/distillation.py``.

A distilled student runs a deterministic, conditional-only DDIM chain over a
static descending ``times`` grid, the guidance weight baked in (no doubled
batch, no injected noise):

    recon = clip(sra(t) x - srm(t) eps(x, t, context), -1, 1)
    x     = c1(t) recon + c2(t) x

with a final (t -> -1) pair that returns recon (c1 = 1, c2 = 0). The tables
are computed in float64 and cast to float32, as in the JAX package. The
training half (``make_distill_step``, ``distill_pair_tables``) is not ported.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.schedules import DiffusionSchedule
from .gaussian_diffusion import DenoiseFn

__all__ = ["ddim_time_grid", "halve_times", "ddim_affine_coefs", "make_student_ddim_sampler"]


def ddim_time_grid(n_steps: int, t_start: Optional[int] = None) -> List[int]:
    """The finest DDIM grid, every timestep descending: [t_start, ..., 1, 0];
    ``t_start`` defaults to T - 1."""
    if t_start is None:
        t_start = n_steps - 1
    return list(range(t_start, -1, -1))


def halve_times(times: Sequence[int]) -> List[int]:
    """Coarsen a descending grid by 2, keeping every other entry from the first."""
    return list(times)[::2]


def _abar(schedule: DiffusionSchedule) -> np.ndarray:
    return schedule.alphas_cumprod.double().cpu().numpy()


def _pair_coefs(schedule: DiffusionSchedule, t: int, t_next: int):
    """(c1, c2) of the update x' = c1 recon + c2 x for the pair t -> t_next,
    from DDIM's x' = sqrt(abar') recon + sqrt(1 - abar') eps with
    eps = (sra(t) x - recon) / srm(t); t_next < 0 returns recon."""
    if t_next < 0:
        return 1.0, 0.0
    abar = _abar(schedule)
    sra = float(np.sqrt(1.0 / abar[t]))
    srm = float(np.sqrt(1.0 / abar[t] - 1.0))
    a_next = float(abar[t_next])
    c = float(np.sqrt(1.0 - a_next))
    return float(np.sqrt(a_next)) - c / srm, c * sra / srm


def ddim_affine_coefs(schedule: DiffusionSchedule, times: Sequence[int]) -> Dict[str, np.ndarray]:
    """Per-step tables of the affine chain over ``times`` (descending, a
    final (t, -1) recon pair appended): ``t`` (int32 eval timesteps) and
    float32 ``sra``, ``srm``, ``c1``, ``c2``, each of length len(times)."""
    ts = list(times)
    pairs = list(zip(ts, ts[1:] + [-1]))
    abar = _abar(schedule)
    t_arr = np.asarray([p[0] for p in pairs], np.int32)
    c1c2 = np.asarray([_pair_coefs(schedule, t, tn) for t, tn in pairs], np.float64)
    return {
        "t": t_arr,
        "sra": np.sqrt(1.0 / abar[t_arr]).astype(np.float32),
        "srm": np.sqrt(1.0 / abar[t_arr] - 1.0).astype(np.float32),
        "c1": c1c2[:, 0].astype(np.float32),
        "c2": c1c2[:, 1].astype(np.float32),
    }


def make_student_ddim_sampler(schedule: DiffusionSchedule, denoise: DenoiseFn,
                              times: Sequence[int]) -> Callable:
    """``sample(context (B, C), x_init (B, H, D) or broadcastable) -> x``: the
    student's conditional-only affine DDIM chain over ``times``, with
    ``denoise(x, t, context, context_mask) -> eps`` (a ``TemporalUnet``).
    The context mask is zeros, so a ``cfg_indicator`` model sees the
    context-present bit 1. The reconstruction is always clipped to [-1, 1]
    (the JAX sampler's default; the ported kernels run only that). The
    chain is deterministic given ``x_init``, the
    JAX sampler's pinned initial draw; its signature is a ``sample_override``'s
    in ``control/runtime.py``. The plain reference of the DDIM chain and
    episode kernels (``ops/fused_denoise.py``, ``ops/fused_episode.py``)."""
    tab = ddim_affine_coefs(schedule, times)
    t_tab = torch.from_numpy(tab["t"].astype(np.int64))
    coefs = torch.from_numpy(np.stack([tab["sra"], tab["srm"], tab["c1"], tab["c2"]], axis=1))

    @torch.no_grad()
    def sample(context: torch.Tensor, x_init: torch.Tensor) -> torch.Tensor:
        b, dev = context.shape[0], context.device
        x = torch.broadcast_to(x_init, (b,) + tuple(x_init.shape[-2:])).to(torch.float32)
        mask = torch.zeros((b, 1), dtype=torch.float32, device=dev)
        cs, ts = coefs.to(dev), t_tab.to(dev)
        for i in range(len(t_tab)):
            sra, srm, c1, c2 = cs[i]
            eps = denoise(x, ts[i].expand(b), context, mask)
            recon = torch.clamp(sra * x - srm * eps, -1.0, 1.0)
            x = c1 * recon + c2 * x
        return x

    return sample
