"""Progressive distillation: port of
``mpc_via_diffusion_model_tpu/diffusion/distillation.py``, both halves.

The sampler: a distilled student runs a deterministic, conditional-only
DDIM chain over a static descending ``times`` grid, the guidance weight
baked in (no doubled batch, no injected noise):

    recon = clip(sra(t) x - srm(t) eps(x, t, context), -1, 1)
    x     = c1(t) recon + c2(t) x

with a final (t -> -1) pair that returns recon (c1 = 1, c2 = 0); the clip
is ``clip_denoised``'s, on by default.

The training half: each round halves the teacher's grid, and the student
learns to land with ONE DDIM step where the teacher lands with two
(``distill_pair_tables``). The first round also bakes the CFG weight ``w``
into the student (``teacher_cfg``: the teacher's eps is (1 + w) eps_cond -
w eps_uncond on one doubled batch). Targets live in x0-space, weighted by
``max(snr, 1)``. ``make_distill_step`` is ``train/trainer.py``'s NaN-guarded
Adam + EMA step over ``distill_loss``, so ``make_scanned_train_steps``
chunks it as it chunks the diffusion loss; its draws are staged (``j`` (B,)
int64, the pair of each row, and ``noise`` (B, H, D)) or drawn from a
``torch.Generator`` in that order, as the JAX loss draws them from its two
keys.

Every table is computed in float64 and cast to float32, as in the JAX
package.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.schedules import DiffusionSchedule
from .gaussian_diffusion import DenoiseFn

__all__ = ["ddim_time_grid", "halve_times", "ddim_affine_coefs", "distill_pair_tables",
           "distill_loss", "make_distill_step", "make_student_ddim_sampler"]

# guide_fn(x_norm (B, H, D), ctx_norm (B, C)) -> delta (B, H, D)
GuideFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


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


def distill_pair_tables(schedule: DiffusionSchedule,
                        teacher_times: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Per-student-pair tables of one distillation round, under the JAX
    function's keys: ``t_hi`` and ``mid`` (int64) and float32 ``a_c1``,
    ``a_c2``, ``b_c1``, ``b_c2``, ``a_sra``, ``a_srm``, ``b_sra``, ``b_srm``,
    ``s_c1``, ``s_c2`` and ``snr_w``, each of length len(halve_times(teacher_times)).

    Pair j's two teacher sub-steps are ts[j] -> mid_j -> lo_j, where ts is the
    student grid and lo_j is ts[j + 1], or -1 (the final recon) for the last
    pair. The last pair follows the teacher grid's parity: of odd length
    (ts ends at 0) its first sub-step is the teacher's (0 -> -1) recon and its
    second the identity; of even length (ts ends at 1) it is the two-step
    (1 -> 0 -> -1) chain."""
    ts, tt = halve_times(teacher_times), list(teacher_times)
    n_pairs = len(ts)
    stu = ddim_affine_coefs(schedule, ts)
    abar = _abar(schedule)
    mids, a_c1, a_c2, b_c1, b_c2, a_sra, a_srm, b_sra, b_srm = ([] for _ in range(9))
    for j in range(n_pairs):
        t_hi = ts[j]
        lo = ts[j + 1] if j < n_pairs - 1 else -1
        if 2 * j + 1 < len(tt):
            mid = tt[2 * j + 1]
            a, b = _pair_coefs(schedule, t_hi, mid), _pair_coefs(schedule, mid, lo)
        else:
            mid = 0
            a, b = _pair_coefs(schedule, t_hi, -1), (0.0, 1.0)
        mids.append(mid)
        a_c1.append(a[0]); a_c2.append(a[1]); b_c1.append(b[0]); b_c2.append(b[1])
        a_sra.append(float(np.sqrt(1.0 / abar[t_hi])))
        a_srm.append(float(np.sqrt(1.0 / abar[t_hi] - 1.0)))
        b_sra.append(float(np.sqrt(1.0 / abar[mid])))
        b_srm.append(float(np.sqrt(max(1.0 / abar[mid] - 1.0, 1e-20))))
    a_ts = abar[np.asarray(ts)]
    f32 = lambda v: torch.from_numpy(np.asarray(v, np.float64).astype(np.float32))
    return {
        "t_hi": torch.tensor(ts, dtype=torch.int64), "mid": torch.tensor(mids, dtype=torch.int64),
        "a_c1": f32(a_c1), "a_c2": f32(a_c2), "b_c1": f32(b_c1), "b_c2": f32(b_c2),
        "a_sra": f32(a_sra), "a_srm": f32(a_srm), "b_sra": f32(b_sra), "b_srm": f32(b_srm),
        "s_c1": torch.from_numpy(stu["c1"]), "s_c2": torch.from_numpy(stu["c2"]),
        "snr_w": f32(np.maximum(a_ts / (1.0 - a_ts + 1e-12), 1.0)),
    }


def _guide_gates(teacher_times: Sequence[int], t_start_guide: float) -> Tuple[list, list]:
    """Per pair, whether each teacher sub-step gets the guide: a sub-step
    stepping from t < ``t_start_guide`` does (``ddpm_step``'s rule); the
    identity second sub-step of an odd grid's last pair never does."""
    ts, tt = halve_times(teacher_times), list(teacher_times)
    gate_a = [float(t < t_start_guide) for t in ts]
    gate_b = [float(2 * j + 1 < len(tt) and tt[2 * j + 1] < t_start_guide) for j in range(len(ts))]
    return gate_a, gate_b


def distill_loss(schedule: DiffusionSchedule, model: nn.Module,
                 teacher_params: Mapping[str, torch.Tensor], teacher_times: Sequence[int],
                 w: float = 0.0, teacher_cfg: bool = False, clip_denoised: bool = True,
                 guide_fn: Optional[GuideFn] = None, t_start_guide: float = float("inf")):
    """``loss_fn(params, inputs_norm, condition_norm, draws) -> scalar``: one
    round's distillation loss of ``model``'s forward on ``params`` (a dict by
    parameter name), its teacher the same module on ``teacher_params``.

    ``draws`` holds ``j`` (B,) int64 and ``noise`` (B, H, D), or is a
    ``torch.Generator`` on the data's device from which they are drawn in
    that order. Per row: x_t = sqrt(abar) x0 + sqrt(1 - abar) noise at the
    pair's high timestep; two teacher DDIM sub-steps without gradient (the
    teacher's eps the CFG combination of one doubled batch, context mask
    zeros then ones, with ``teacher_cfg``; each recon clipped with
    ``clip_denoised``; the guide's delta added after each gated sub-step);
    the recon that makes ONE student step land on the target, clipped
    likewise; and the ``snr_w``-weighted mean square of the student's recon
    against it."""
    from ..train.trainer import _functional, _split_draws

    tabs = distill_pair_tables(schedule, teacher_times)
    n_pairs = len(tabs["t_hi"])
    gates = torch.tensor(_guide_gates(teacher_times, t_start_guide), dtype=torch.float32)
    abar = _abar(schedule)
    sqrt_ab = torch.from_numpy(np.sqrt(abar).astype(np.float32))
    sqrt_1mab = torch.from_numpy(np.sqrt(1.0 - abar).astype(np.float32))
    call = _functional(model)
    on_device = {}

    def tables(dev):
        if dev not in on_device:
            on_device[dev] = ({k: v.to(dev) for k, v in tabs.items()}, gates.to(dev),
                              sqrt_ab.to(dev), sqrt_1mab.to(dev))
        return on_device[dev]

    def teacher_eps(x, t, ctx):
        b = x.shape[0]
        if teacher_cfg:
            mask2 = torch.cat([torch.zeros((b, 1), dtype=x.dtype, device=x.device),
                               torch.ones((b, 1), dtype=x.dtype, device=x.device)])
            eps2 = call(teacher_params, torch.cat([x, x]), torch.cat([t, t]),
                        torch.cat([ctx, ctx]), mask2)
            return (1.0 + w) * eps2[:b] - w * eps2[b:]
        return call(teacher_params, x, t, ctx, torch.zeros((b, 1), dtype=x.dtype, device=x.device))

    clip = (lambda v: torch.clamp(v, -1.0, 1.0)) if clip_denoised else (lambda v: v)

    def loss_fn(params, x0, ctx, draws=None):
        generator, staged = _split_draws(draws)
        b, dev = x0.shape[0], x0.device
        j = staged.get("j")
        if j is None:
            j = torch.randint(0, n_pairs, (b,), generator=generator, device=dev)
        noise = staged.get("noise")
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=dev)
        T, (gate_a, gate_b), s_ab, s_1mab = tables(dev)
        expand = lambda v: v.reshape((b,) + (1,) * (x0.dim() - 1))
        t_hi = T["t_hi"][j]
        x_t = expand(s_ab[t_hi]) * x0 + expand(s_1mab[t_hi]) * noise

        # two teacher DDIM sub-steps, the targets (no gradient)
        with torch.no_grad():
            eps_a = teacher_eps(x_t, t_hi, ctx)
            recon_a = clip(expand(T["a_sra"][j]) * x_t - expand(T["a_srm"][j]) * eps_a)
            x_mid = expand(T["a_c1"][j]) * recon_a + expand(T["a_c2"][j]) * x_t
            if guide_fn is not None:
                x_mid = x_mid + expand(gate_a[j]) * guide_fn(x_mid, ctx)
            eps_b = teacher_eps(x_mid, T["mid"][j], ctx)
            recon_b = clip(expand(T["b_sra"][j]) * x_mid - expand(T["b_srm"][j]) * eps_b)
            x_tgt = expand(T["b_c1"][j]) * recon_b + expand(T["b_c2"][j]) * x_mid
            if guide_fn is not None:
                x_tgt = x_tgt + expand(gate_b[j]) * guide_fn(x_tgt, ctx)
            # the x0 the student must predict so that ONE step lands at x_tgt
            recon_star = clip((x_tgt - expand(T["s_c2"][j]) * x_t) / expand(T["s_c1"][j]))

        eps_s = call(params, x_t, t_hi, ctx, torch.zeros((b, 1), dtype=x0.dtype, device=dev))
        recon_s = expand(T["a_sra"][j]) * x_t - expand(T["a_srm"][j]) * eps_s
        return torch.mean(expand(T["snr_w"][j]) * torch.square(recon_s - recon_star))

    return loss_fn


def make_distill_step(schedule: DiffusionSchedule, model: nn.Module, optimizer,
                      teacher_params: Mapping[str, torch.Tensor], teacher_times: Sequence[int],
                      w: float = 0.0, teacher_cfg: bool = False, clip_denoised: bool = True,
                      ema_decay: float = 0.995, step_start_ema: int = 200,
                      update_ema_every: int = 10, guide_fn: Optional[GuideFn] = None,
                      t_start_guide: float = float("inf")):
    """One progressive-distillation round's train step: ``(step_fn,
    student_times)``, the student grid ``halve_times(teacher_times)``.

    ``step_fn(state, inputs_norm, condition_norm, draws) -> (state,
    metrics)`` is ``make_custom_train_step`` over ``distill_loss`` (the NaN
    guard, ``optimizer``'s update and the EMA, with the JAX step's
    ``step_start_ema`` default of 200), so it plugs into
    ``make_scanned_train_steps``. ``model`` is the module the student's
    flat parameters (``state.params``) are laid out for; ``teacher_params``
    maps its parameter names to the teacher's tensors (e.g.
    ``layout.views(ema)`` of the previous round), on the data's device.
    ``teacher_cfg=True`` evaluates the teacher with CFG at weight ``w``
    (the first round bakes guidance in); ``guide_fn`` bakes a sampling-time
    guide into the student, on the teacher sub-steps that step from t <
    ``t_start_guide``."""
    from ..train.trainer import make_custom_train_step

    loss_fn = distill_loss(schedule, model, teacher_params, teacher_times, w, teacher_cfg,
                           clip_denoised, guide_fn, t_start_guide)
    step = make_custom_train_step(loss_fn, optimizer, ema_decay, step_start_ema, update_ema_every)
    return step, halve_times(teacher_times)


def make_student_ddim_sampler(schedule: DiffusionSchedule, denoise: DenoiseFn,
                              times: Sequence[int], clip_denoised: bool = True) -> Callable:
    """``sample(context (B, C), x_init (B, H, D) or broadcastable) -> x``: the
    student's conditional-only affine DDIM chain over ``times``, with
    ``denoise(x, t, context, context_mask) -> eps`` (a ``TemporalUnet``).
    The context mask is zeros, so a ``cfg_indicator`` model sees the
    context-present bit 1. ``clip_denoised`` clamps each reconstruction to
    [-1, 1], as the distill targets are (the JAX sampler's default; the DDIM
    kernels run only that, ROADMAP.md B1). The chain is deterministic given
    ``x_init``, the JAX sampler's pinned initial draw; its signature is a
    ``sample_override``'s in ``control/runtime.py``. The plain reference of
    the DDIM chain and episode kernels (``ops/fused_denoise.py``,
    ``ops/fused_episode.py``)."""
    tab = ddim_affine_coefs(schedule, times)
    t_tab = torch.from_numpy(tab["t"].astype(np.int64))
    coefs = torch.from_numpy(np.stack([tab["sra"], tab["srm"], tab["c1"], tab["c2"]], axis=1))
    clip = (lambda v: torch.clamp(v, -1.0, 1.0)) if clip_denoised else (lambda v: v)

    @torch.no_grad()
    def sample(context: torch.Tensor, x_init: torch.Tensor) -> torch.Tensor:
        b, dev = context.shape[0], context.device
        x = torch.broadcast_to(x_init, (b,) + tuple(x_init.shape[-2:])).to(torch.float32)
        mask = torch.zeros((b, 1), dtype=torch.float32, device=dev)
        cs, ts = coefs.to(dev), t_tab.to(dev)
        for i in range(len(t_tab)):
            sra, srm, c1, c2 = cs[i]
            eps = denoise(x, ts[i].expand(b), context, mask)
            recon = clip(sra * x - srm * eps)
            x = c1 * recon + c2 * x
        return x

    return sample
