"""The scene-conditioned quadrotor study on the card: the port of the JAX
package's ``scripts/scene_conditioned_quadrotor.py``, its making half (steps
1-3, ``:166-276``) and its held-out evaluation (step 4, ``:278-395``), its
rows and JSON keys, and of its ``widen_film_params`` (``:48-74``) with the
warm-start check.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.scene_conditioned_quadrotor \\
        [--make] [--quick] [--n-sample-chunks 24] [--chunk-rows 2048] \\
        [--finetune-steps 30000] [--eval-scenes 8] [--eval-starts 16] [--eval-steps 60] \\
        [--select-k 16] [--device cuda] [--out PATH] [...]

With ``--make`` the script makes a scene student from the quadrotor flagship's teacher, then evaluates the
MADE student:

1. Guided data with per-row scenes: ``--n-sample-chunks`` chunks of
   ``--chunk-rows`` rows B, each row an x0 of the teacher's dataset
   (``dataset.npz`` beside its pickle; the rows of
   ``RandomState(5).randint(0, n_pool, B)`` per chunk) in its own scene
   (``sample_scenes(n_chunks B, seed=1)``), sampled by the teacher's CFG DDPM
   chain (T = 25 + 5, w = 0.01) with each row's own scene's obstacle guide
   (``make_penalty_grad(..., scene_args=True)``, one step on i <
   ``--t-start-guide``), every U-Net pass through the U-Net pass kernel at 2
   B rows. The noise of chunk c is ``torch.Generator(device).manual_seed(17
   + c)``'s: the JAX script splits ``PRNGKey(17)``, whose draws torch cannot
   reproduce. A plan is kept when its open-loop rollout from its x0 clears
   its own scene by more than ``--clear-margin`` and ends within
   ``--progress-keep`` of its start's goal distance (or starts within 0.5 of
   the goal); a rollout that blows up counts as rejected. Its context is the
   normalized state followed by its scene's normalized features (24).
2. The teacher's context widened from 12 to 24 (``widen_film_params``), held
   to the teacher on the JAX script's probe (below 1e-5).
3. The fine-tune: ``--finetune-steps`` steps (``make_train_step``'s EMA
   defaults, Adam at ``--finetune-lr``) in chunks of ``--chunk`` at batch
   ``--batch-size``, drawn from ``torch.Generator(device).manual_seed(23)``;
   the EMA weights go to ``scene_student_ema.pkl`` (the JAX package's layout,
   ``{'params': ...}`` of numpy arrays) and the kept data to
   ``scene_dataset.npz`` (``inputs_normalized``, ``condition_normalized``),
   both in the directory of ``--out``.

Without ``--make`` the committed scene student
(``artifacts/scene_conditioned/scene_student_ema.pkl``) is evaluated and the
making keys of the report are None. ``--quick`` is the JAX script's smoke
size: 2 x 256 rows, 400 steps in chunks of 100 at batch 64, 2 x 4 pairs x 20
replans, K = 4.

Step 4: every (scene, start) pair of ``--eval-scenes`` held-out scenes
(``sample_scenes(n, seed=99)``) and ``--eval-starts`` starts
(``eval_start_states(n, seed=11)``) flies ``--eval-steps`` replans, T = 25 +
5, w = 0.01, each row as one loop batched over the pairs (``make_closed_loop``
with x0 (N, 12), each pair's noise drawn in turn from
``torch.Generator(device).manual_seed(31)``, as the JAX script splits
``PRNGKey(31)`` once for every row):

- ``teacher_scene_blind``: the quadrotor flagship's teacher
  (``artifacts/flagship_quadrotor/ema_params.pkl``, context 12), unguided,
  through the CFG chain kernel at N samples;
- ``teacher_per_scene_guided_oracle``: the same teacher with each pair's
  own scene's obstacle guide (``make_penalty_grad(..., scene_args=True)``)
  on its steps i < ``--t-start-guide``, every U-Net pass through the U-Net
  pass kernel at 2 N rows;
- ``scene_conditioned_student``: the scene student (context 24: the state
  followed by the pair's scene features), through the chain at N;
- ``scene_conditioned_student_k{K}``: the same at K = ``--select-k``
  candidates scored by the pair's scene's safety-first selection cost
  (``make_select_cost(quad_cost, centers, radii)``), the chain at N K;
- ``canonical_scene_student``: the student on the canonical scene from the
  starts alone (noise seed 47).

Each held-out row has ``track_metrics`` against its pairs' scenes,
``per_scene_cf`` and the seconds and kernel launches it took. The rows of
the scene-blind teacher and of the oracle also carry, in
``scene0_yardstick``, their first 16 pairs' (scene 0's) metrics and whether
they lie within ``data/guided_yardstick.py``'s bounds, and ``paired_gate``
the two rows' paired gate on scene 0 (only when the protocol is the
yardstick's). ``warm_start_max_err`` is the widened teacher's largest gap
from the teacher on the JAX script's probe. The report goes to ``--out``
(``chiprun_out/scene_conditioned_quadrotor/report.json`` by default), never
under ``artifacts/``.
"""
from __future__ import annotations

import argparse
import json
import pickle
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from ..core.schedules import make_schedule
from ..data import guided_yardstick as gys
from ..data import scene_yardstick as sys_
from ..data.datasets import ControlSequenceDataset
from ..data.normalization import NormalizerStats, normalize, unnormalize
from ..data.quadrotor_stats import quadrotor_stats
from ..data.scene_stats import scene_feature_stats, scene_stats
from ..diffusion.gaussian_diffusion import GaussianDiffusion
from ..dynamics.base import Plant, rollout
from ..dynamics.quadrotor import quadrotor, quadrotor_cost
from ..models.temporal_unet import TemporalUnet
from ..models.weights import (SCENE_STUDENT_CONFIG, load_quadrotor_teacher, load_scene_student,
                              to_flax_params)
from ..ops.fused_unet import make_fused_unet
from ..ops.unet_pack import PackedUnet, pack_unet
from ..train.trainer import (ParamLayout, TrainState, make_optimizer, make_scanned_train_steps,
                             make_train_step)
from ..utils.device import resolve_device
from .bench_scene_student import start_noise
from .flagship_quadrotor import serving_loop
from .quadrotor_task import (OBS_CENTERS, OBS_RADII, eval_start_states, make_penalty_grad,
                             make_select_cost, min_clearance, min_clearance_torch, rows_of,
                             sample_scenes,
                             scene_features, track_metrics)

__all__ = ["widen_film_params", "warm_start_error", "Pairs", "scene_guide_builder",
           "SceneSelectCost", "row_features", "teacher_loop", "student_loop", "QUICK",
           "teacher_files", "load_pool", "scene_context", "sample_chunk", "plan_stats", "keep_mask",
           "chunk_noise", "make_guided_data", "widened_teacher", "new_train_state", "finetune",
           "save_student", "make_student", "main"]

ROOT = Path(__file__).resolve().parents[2]
HORIZON = 48
# the JAX script's --quick (:113-117)
QUICK = dict(n_sample_chunks=2, chunk_rows=256, finetune_steps=400, chunk=100, batch_size=64,
             eval_scenes=2, eval_starts=4, eval_steps=20, select_k=4)
# the JAX script's seeds: the pool's rows RandomState(5), the training scenes sample_scenes(seed=1),
# the sampling noise PRNGKey(17) and the fine-tune's PRNGKey(23) (torch generators here)
POOL_SEED, SCENE_DRAW_SEED, NOISE_SEED, TRAIN_SEED = 5, 1, 17, 23
# --seed s moves every torch generator's seed by SEED_STRIDE s (0: the seeds above)
SEED_STRIDE = 1000


def widen_film_params(sd12: Mapping[str, torch.Tensor], sd24: Mapping[str, torch.Tensor],
                      old_ctx: int, new_ctx: int, cfg_indicator: bool) -> Dict[str, torch.Tensor]:
    """The teacher's state dict carried into the widened-context one: the
    only tensors whose shapes differ are the FiLM Linear weights (C,
    t_dim + ctx + cfg), which get zero columns for the new context dims
    after the teacher's (before the context-present bit), so that the
    widened model computes the teacher's function while those dims are zero.
    Everything else is copied as it is."""
    cfg = 1 if cfg_indicator else 0
    extra = new_ctx - old_ctx
    out = {}
    for name, new in sd24.items():
        old = sd12[name]
        if old.shape == new.shape:
            out[name] = old.clone()
            continue
        if not (old.dim() == 2 and new.shape[1] == old.shape[1] + extra):
            raise ValueError(f"unexpected widened tensor {name}: {tuple(old.shape)} -> "
                             f"{tuple(new.shape)}")
        keep = old.shape[1] - cfg
        out[name] = torch.cat([old[:, :keep], old.new_zeros((old.shape[0], extra)),
                               old[:, keep:]], dim=1)
    return out


@torch.no_grad()
def warm_start_error(model12: TemporalUnet, model24: TemporalUnet) -> float:
    """The JAX script's check of the widening: both models on its probe (x
    = 0.1, t = 5 and 17, the old context a ramp over [-0.5, 0.5], the new
    dims 0, no mask); the largest |difference|."""
    dev = next(model12.parameters()).device
    h, d = model12.n_support_points, model12.state_dim
    probe = torch.full((2, h, d), 0.1, device=dev)
    t = torch.tensor([5, 17], device=dev)
    cp12 = torch.linspace(-0.5, 0.5, model12.context_dim, device=dev)[None].expand(2, -1)
    cp24 = torch.cat([cp12, torch.zeros((2, model24.context_dim - model12.context_dim),
                                        device=dev)], dim=1)
    mask = torch.zeros((2, 1), device=dev)
    return float((model12(probe, t, cp12, mask) - model24(probe, t, cp24, mask)).abs().max())


class Pairs:
    """The (scene, start) pairs of the held-out evaluation, scene-major: pair
    p = e S + s flies start s through scene e."""

    def __init__(self, n_scenes: int, n_starts: int, device):
        self.n_scenes, self.n_starts = n_scenes, n_starts
        ev_c, ev_r = sample_scenes(n_scenes, seed=gys.SCENE_SEED)
        self.scene_centers, self.scene_radii = ev_c, ev_r
        starts = eval_start_states(n_starts, seed=gys.SCENE_START_SEED)
        self.centers = torch.from_numpy(np.repeat(ev_c, n_starts, axis=0)).to(device)
        self.radii = torch.from_numpy(np.repeat(ev_r, n_starts, axis=0)).to(device)
        self.x0 = torch.from_numpy(np.tile(starts, (n_scenes, 1))).to(device)

    def __len__(self) -> int:
        return self.x0.shape[0]

    def metrics(self, x_track: np.ndarray) -> dict:
        """``track_metrics`` against each pair's scene, and each scene's
        collision-free fraction (``per_scene_cf``)."""
        s = self.n_starts
        out = track_metrics(x_track, centers=self.centers.cpu().numpy(),
                            radii=self.radii.cpu().numpy())
        out["per_scene_cf"] = [
            track_metrics(x_track[e * s:(e + 1) * s], centers=self.scene_centers[e],
                          radii=self.scene_radii[e])["collision_free_fraction"]
            for e in range(self.n_scenes)]
        return out


def scene_guide_builder(plant: Plant, in_stats: NormalizerStats, guide_scale: float,
                        centers: torch.Tensor, radii: torch.Tensor) -> Callable:
    """``guide_builder(x0 (N, 12))`` whose guide descends each row's obstacle
    penalty in its own scene (centers (N, 3, 3), radii (N, 3)): the JAX
    script's per-pair ``guide_builder`` of its oracle, batched."""
    per = make_penalty_grad(plant, in_stats, guide_scale, scene_args=True)

    def guide_builder(x0):
        def guide(u_norm):
            n = u_norm.shape[0]
            return per(u_norm, rows_of(x0, n), rows_of(centers, n), rows_of(radii, n))

        return guide

    return guide_builder


class SceneSelectCost:
    """Each row's scene's safety-first selection cost
    (``make_select_cost(quad_cost, centers, radii)``) for a batched loop: x
    (N, 12) for the loop's stage costs, (N, K, 12) for the candidates."""

    def __init__(self, centers: torch.Tensor, radii: torch.Tensor):
        self.centers, self.radii = centers, radii
        dev = centers.device
        self.rows = make_select_cost(quadrotor_cost(), centers=centers, radii=radii).to(dev)
        self.cands = make_select_cost(quadrotor_cost(), centers=centers[:, None],
                                      radii=radii[:, None]).to(dev)

    def to(self, device) -> "SceneSelectCost":
        return SceneSelectCost(self.centers.to(device), self.radii.to(device))

    def _pick(self, x):
        return self.cands if x.dim() == 3 else self.rows

    def stage(self, x, u):
        return self._pick(x).stage(x, u)

    def terminal(self, x):
        return self._pick(x).terminal(x)


def row_features(centers: torch.Tensor, radii: torch.Tensor) -> Callable:
    """``state_to_condition`` of a batched loop: each row's state followed by
    its own scene's 12 features."""
    feats = scene_features(centers, radii)
    return lambda x: torch.cat([x, feats.to(x.device)], dim=-1)


def teacher_loop(packed: PackedUnet, centers: torch.Tensor, radii: torch.Tensor, n_steps: int,
                 device, guided: bool, guide_scale: float = gys.GUIDE_SCALE,
                 t_start_guide: float = gys.T_START_SCENE, route=None):
    """``(loop, route)``: the teacher over rows with their scenes (centers
    (N, 3, 3), radii (N, 3)), the task quadratic as the loop's cost;
    guided, each row's scene's guide on the steps i < ``t_start_guide``."""
    stats = quadrotor_stats()
    gb = (scene_guide_builder(quadrotor(), stats[0], guide_scale, centers, radii)
          if guided else None)
    return serving_loop(packed, stats, quadrotor_cost(), centers.shape[0], n_steps, device,
                        guide_builder=gb, t_start_guide=t_start_guide, route=route)


def student_loop(packed: PackedUnet, centers: torch.Tensor, radii: torch.Tensor, n_steps: int,
                 device, k: int = 1):
    """``(loop, chain)``: the scene student over rows with their scenes
    (centers (N, 3, 3), radii (N, 3)), the chain at N K samples; at K > 1
    candidates scored by each row's scene's selection cost."""
    cost = SceneSelectCost(centers, radii) if k > 1 else quadrotor_cost()
    return serving_loop(packed, scene_stats(), cost, centers.shape[0], n_steps, device,
                        n_candidates=k, state_to_condition=row_features(centers, radii))


def teacher_files(teacher) -> Tuple[Path, Path]:
    """(pickle, dataset) of ``--teacher``: a directory holding
    ``ema_params.pkl`` and ``dataset.npz`` (the JAX script's argument), or
    the pickle, its dataset beside it."""
    t = Path(teacher)
    pkl = t / "ema_params.pkl" if t.is_dir() else t
    return pkl, pkl.parent / "dataset.npz"


def load_pool(dataset_path, device) -> ControlSequenceDataset:
    """The teacher's dataset on ``device``: its conditions are the x0 pool
    and their normalized twins (limits of its own statistics, which are
    ``data/quadrotor_stats.py``'s)."""
    return ControlSequenceDataset.load(str(dataset_path), device=device)


def scene_context(cond_norm: torch.Tensor, centers: torch.Tensor,
                  radii: torch.Tensor) -> torch.Tensor:
    """The 24-dim context of rows: the normalized state (B, 12) followed by
    the normalized features of each row's scene (the JAX script's ctx24)."""
    feat = normalize(scene_feature_stats().to(cond_norm.device),
                     scene_features(centers, radii).to(cond_norm.device))
    return torch.cat([cond_norm, feat], dim=-1)


def sample_chunk(denoise, x0s: torch.Tensor, cond_norm: torch.Tensor, centers: torch.Tensor,
                 radii: torch.Tensor, noise: torch.Tensor, guide_scale: float = gys.GUIDE_SCALE,
                 t_start_guide: float = gys.T_START_SCENE,
                 w: float = gys.W) -> Dict[str, torch.Tensor]:
    """One chunk of guided scene data (the JAX script's ``sample_chunk``):
    B rows from the states x0s (B, 12) with their normalized twins
    ``cond_norm`` and scenes (centers (B, 3, 3), radii (B, 3)), sampled by
    ``denoise`` (the teacher at 2 B rows) with each row's own scene's guide
    on the staged ``noise`` (n_total + 1, B, H, 4). Returns ``u_norm``, the
    open-loop rollout's min clearance from the row's scene (``clear``), the
    start's and the rollout's last goal distance (``d0``, ``d1``) and the
    rows' 24-dim context (``ctx24``)."""
    plant = quadrotor()
    ins = quadrotor_stats()[0].to(x0s.device)
    per = make_penalty_grad(plant, ins, guide_scale, scene_args=True)
    diffusion = GaussianDiffusion(make_schedule("exponential", gys.T)).to(x0s.device)
    u_norm = diffusion.ddpm_cfg_sample(
        denoise, tuple(noise.shape[1:]), cond_norm, w=w,
        n_diffusion_steps_without_noise=gys.N_TAIL, noise=noise,
        guide=lambda u: per(u, x0s, centers, radii), n_guide_steps=1,
        t_start_guide=t_start_guide)
    return {"u_norm": u_norm, **plan_stats(u_norm, x0s, centers, radii),
            "ctx24": scene_context(cond_norm, centers, radii)}


def plan_stats(u_norm: torch.Tensor, x0s: torch.Tensor, centers: torch.Tensor,
               radii: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The curation's numbers of plans u_norm (B, H, 4) from their states x0s
    (B, 12): the open-loop rollout's min clearance from the row's scene
    (``clear``), the start's and the rollout's last goal distance (``d0``,
    ``d1``); the JAX script's ``plan_stats``."""
    ins = quadrotor_stats()[0].to(x0s.device)
    states = rollout(quadrotor(), x0s, unnormalize(ins, u_norm))
    return {"clear": min_clearance_torch(states, centers, radii),
            "d0": torch.linalg.norm(x0s[:, 0:3], dim=-1),
            "d1": torch.linalg.norm(states[:, -1, 0:3], dim=-1)}


def keep_mask(clear: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor, clear_margin: float,
              progress_keep: float) -> torch.Tensor:
    """The JAX script's curation: clear of the row's own scene by more than
    ``clear_margin``, and (when ``progress_keep`` > 0) the rollout's end
    within ``progress_keep`` of the start's goal distance or the start within
    0.5 of the goal. A NaN clearance (a rollout that blew up) fails."""
    keep = clear > clear_margin
    if progress_keep > 0:
        keep = keep & ((d1 <= progress_keep * d0) | (d0 < 0.5))
    return keep


def chunk_noise(chunk: int, rows: int, device, seed: int = 0) -> torch.Tensor:
    """Chunk ``chunk``'s staged noise (n_total + 1, rows, H, 4), from
    ``torch.Generator(device).manual_seed(17 + chunk + SEED_STRIDE seed)``."""
    gen = torch.Generator(device=device).manual_seed(NOISE_SEED + chunk + SEED_STRIDE * seed)
    return torch.randn((gys.T + gys.N_TAIL + 1, rows, HORIZON, 4), generator=gen,
                       device=device)


def make_guided_data(tpacked: PackedUnet, pool: ControlSequenceDataset, n_chunks: int,
                     chunk_rows: int, device, guide_scale: float = gys.GUIDE_SCALE,
                     t_start_guide: float = gys.T_START_SCENE, clear_margin: float = 0.05,
                     progress_keep: float = 0.85, denoiser=None, log=print,
                     seed: int = 0) -> dict:
    """Step 1: ``n_chunks`` chunks of ``chunk_rows`` guided rows, curated.
    ``denoiser`` is the U-Net pass kernel at 2 B rows unless given. Returns
    the kept ``u`` (n_kept, H, 4) and ``c`` (n_kept, 24), ``n_drawn``,
    ``n_kept``, the kept rows' mean clearance, the seconds, and the
    denoiser and its kernel launches."""
    dev = resolve_device(device)
    b = chunk_rows
    denoiser = denoiser if denoiser is not None else make_fused_unet(tpacked, 2 * b, device=dev)
    rng = np.random.RandomState(POOL_SEED)
    train_c, train_r = sample_scenes(n_chunks * b, seed=SCENE_DRAW_SEED)
    train_c, train_r = torch.from_numpy(train_c).to(dev), torch.from_numpy(train_r).to(dev)
    n_pool = len(pool)
    keep_u, keep_c, keep_clear, per_chunk = [], [], [], []
    if hasattr(denoiser, "launches"):
        denoiser.launches = 0
    t0 = time.perf_counter()
    for c in range(n_chunks):
        idx = torch.from_numpy(rng.randint(0, n_pool, b)).to(dev)
        sl = slice(c * b, (c + 1) * b)
        out = sample_chunk(denoiser, pool.condition[idx], pool.condition_normalized[idx],
                           train_c[sl], train_r[sl], chunk_noise(c, b, dev, seed), guide_scale,
                           t_start_guide)
        keep = keep_mask(out["clear"], out["d0"], out["d1"], clear_margin, progress_keep)
        keep_u.append(out["u_norm"][keep])
        keep_c.append(out["ctx24"][keep])
        keep_clear.append(out["clear"][keep])
        per_chunk.append(int(keep.sum()))
        log(f"[sample] chunk {c + 1}/{n_chunks}: kept {per_chunk[-1]}/{b} "
            f"({time.perf_counter() - t0:.0f}s)")
    u, ctx = torch.cat(keep_u), torch.cat(keep_c)
    clear = torch.cat(keep_clear)
    seconds = time.perf_counter() - t0
    log(f"[sample] {u.shape[0]}/{n_chunks * b} scene-conditioned plans kept in {seconds:.0f}s")
    return {"u": u, "c": ctx, "n_drawn": n_chunks * b, "n_kept": int(u.shape[0]),
            "kept_per_chunk": per_chunk,
            "kept_clearance_mean": float(clear.mean()) if len(clear) else None,
            "seconds": seconds, "denoiser": denoiser,
            "launches": getattr(denoiser, "launches", None)}


def widened_teacher(teacher: TemporalUnet, device) -> Tuple[TemporalUnet, float]:
    """Step 2: the teacher's context widened from 12 to 24
    (``widen_film_params``; the teacher's widths otherwise, for the
    quadrotor's ``SCENE_STUDENT_CONFIG``) and the warm start's largest gap on
    the probe; raises at 1e-5 or more, as the JAX script asserts."""
    model24 = TemporalUnet(
        teacher.state_dim, teacher.n_support_points, teacher.unet_input_dim, teacher.dim_mults,
        teacher.time_emb_dim, context_dim=24, cfg_indicator=True).to(device).eval()
    model24.load_state_dict(widen_film_params(teacher.state_dict(), model24.state_dict(), 12, 24,
                                              cfg_indicator=True))
    err = warm_start_error(teacher, model24)
    if not err < 1e-5:
        raise RuntimeError(f"widening surgery broke the warm start: {err}")
    return model24, err


def new_train_state(model: TemporalUnet, optimizer) -> TrainState:
    """A fresh train state at ``model``'s weights: the EMA a copy of them,
    Adam's state new, step 0."""
    layout = ParamLayout.of(model)
    params = layout.flatten(dict(model.named_parameters())).detach()
    return TrainState(params, params.clone(), optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=params.device), layout)


def finetune(model: TemporalUnet, data_u: torch.Tensor, data_c: torch.Tensor, n_steps: int,
             chunk: int, batch_size: int, lr: float, device, seed: int = TRAIN_SEED,
             log=print, **ema) -> dict:
    """Step 3: ``n_steps // chunk`` chunks of ``make_scanned_train_steps``
    from ``model``'s weights on (data_u, data_c), each step's indices and loss
    draws from ``torch.Generator(device).manual_seed(seed)``; ``ema`` passes
    ``make_train_step``'s EMA settings (its defaults unless given). The loss
    is logged five times, as the JAX script logs it. Returns the final
    ``state``, every step's ``losses`` (a tensor), ``final_loss`` (the last
    chunk's mean) and the seconds."""
    dev = resolve_device(device)
    diffusion = GaussianDiffusion(make_schedule("exponential", gys.T)).to(dev)
    opt = make_optimizer(lr)
    step_fn = make_train_step(diffusion, model, opt, **ema)
    chunk_fn = make_scanned_train_steps(step_fn, chunk)
    state = new_train_state(model, opt)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_chunks = n_steps // chunk
    every = max(1, n_chunks // 5)
    losses, t0 = [], time.perf_counter()
    for c in range(n_chunks):
        state, step_losses = chunk_fn(state, data_u, data_c, batch_size, gen, per_step=True)
        losses.append(step_losses)
        if (c + 1) % every == 0:
            log(f"[finetune] {int(state.step)} steps, loss {float(step_losses.mean()):.5f} "
                f"({time.perf_counter() - t0:.0f}s)")
    losses = torch.cat(losses) if losses else torch.zeros((0,), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    final = float(losses[-chunk:].mean()) if n_chunks else None
    return {"state": state, "losses": losses, "final_loss": final,
            "seconds": time.perf_counter() - t0}


def save_student(path, weights) -> None:
    """A student's weights (a ``TemporalUnet`` or its tensors by name) as the
    JAX package pickles them: ``{'params': ...}`` in the flax layout, numpy
    leaves."""
    with open(path, "wb") as f:
        pickle.dump(to_flax_params(weights), f)


def make_student(tpacked: PackedUnet, pool: ControlSequenceDataset, out_dir: Path, device,
                 n_sample_chunks: int, chunk_rows: int, finetune_steps: int, chunk: int,
                 batch_size: int, finetune_lr: float = 1e-3,
                 guide_scale: float = gys.GUIDE_SCALE, t_start_guide: float = gys.T_START_SCENE,
                 clear_margin: float = 0.05, progress_keep: float = 0.85, denoiser=None,
                 log=print, seed: int = 0) -> dict:
    """Steps 1-3: the guided data, the widened teacher, the fine-tune; writes
    ``scene_student_ema.pkl`` and ``scene_dataset.npz`` into ``out_dir``.
    Returns the made ``student`` (a ``TemporalUnet`` with the EMA weights),
    the data's and the fine-tune's records and the report's making keys."""
    dev = resolve_device(device)
    data = make_guided_data(tpacked, pool, n_sample_chunks, chunk_rows, dev, guide_scale,
                            t_start_guide, clear_margin, progress_keep, denoiser, log, seed)
    model24, warm_err = widened_teacher(tpacked.model, dev)
    log(f"[widen] warm-start max err {warm_err:.2e}")
    ft = finetune(model24, data["u"], data["c"], finetune_steps, chunk, batch_size, finetune_lr,
                  dev, TRAIN_SEED + SEED_STRIDE * seed, log=log)
    out_dir.mkdir(parents=True, exist_ok=True)
    ema = ft["state"].layout.views(ft["state"].ema_params)
    save_student(out_dir / "scene_student_ema.pkl", ema)
    np.savez_compressed(out_dir / "scene_dataset.npz",
                        inputs_normalized=data["u"].cpu().numpy(),
                        condition_normalized=data["c"].cpu().numpy())
    student = TemporalUnet(**SCENE_STUDENT_CONFIG, cfg_indicator=True).to(dev).eval()
    student.load_state_dict(ema)
    keys = {"n_kept": data["n_kept"], "n_drawn": data["n_drawn"],
            "sample_seconds": round(data["seconds"], 1), "finetune_steps": finetune_steps,
            "finetune_seconds": round(ft["seconds"], 1), "final_loss": ft["final_loss"]}
    making = {"keep_fraction": data["n_kept"] / data["n_drawn"],
              "kept_clearance_mean": data["kept_clearance_mean"],
              "kept_per_chunk": data["kept_per_chunk"], "sample_launches": data["launches"],
              "first_losses": ft["losses"][:20].tolist(),
              "student_path": str(out_dir / "scene_student_ema.pkl"),
              "dataset_path": str(out_dir / "scene_dataset.npz")}
    return {"student": student, "warm_err": warm_err, "data": data, "finetune": ft,
            "keys": keys, "making": making}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(loop, route, x0, noise, dev):
    route.launches = 0
    t0 = time.perf_counter()
    res = loop(x0, noise)
    _sync(dev)
    return res.x_track.cpu().numpy(), time.perf_counter() - t0, route.launches


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--teacher", default=str(gys.TEACHER),
                   help="the teacher's pickle, or its directory (ema_params.pkl, dataset.npz)")
    p.add_argument("--student", default=str(sys_.STUDENT),
                   help="the scene student evaluated without --make")
    p.add_argument("--horizon", type=int, default=HORIZON, choices=[HORIZON])
    p.add_argument("--w", type=float, default=gys.W, choices=[gys.W])
    p.add_argument("--guide-scale", type=float, default=gys.GUIDE_SCALE)
    p.add_argument("--t-start-guide", type=float, default=gys.T_START_SCENE)
    p.add_argument("--n-sample-chunks", type=int, default=24)
    p.add_argument("--chunk-rows", type=int, default=2048)
    p.add_argument("--clear-margin", type=float, default=0.05)
    p.add_argument("--progress-keep", type=float, default=0.85)
    p.add_argument("--select-k", type=int, default=16)
    p.add_argument("--finetune-steps", type=int, default=30000)
    p.add_argument("--chunk", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--finetune-lr", type=float, default=1e-3)
    p.add_argument("--eval-scenes", type=int, default=gys.N_SCENES)
    p.add_argument("--eval-starts", type=int, default=gys.N_STARTS)
    p.add_argument("--eval-steps", type=int, default=gys.N_STEPS)
    p.add_argument("--make", action="store_true",
                   help="steps 1-3: make the student from the teacher, then evaluate it")
    p.add_argument("--no-teacher-rows", action="store_true",
                   help="leave out the teacher's scene-blind and oracle rows")
    p.add_argument("--quick", action="store_true",
                   help="smoke size: 2 x 256 rows, 400 fine-tune steps, 2 x 4 x 20 eval, K = 4")
    p.add_argument("--seed", type=int, default=0,
                   help=f"moves every torch seed by {SEED_STRIDE} x this (0: the JAX script's)")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--device", default=None, help="cuda unless given")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "scene_conditioned_quadrotor" /
                                        "report.json"))
    args = p.parse_args(argv)
    if args.quick:
        for name, value in QUICK.items():
            setattr(args, name, value)
    out_path = Path(args.out).resolve()
    if (ROOT / "artifacts") in out_path.parents:
        raise SystemExit(f"--out {args.out}: the report goes under chiprun_out/, not artifacts/")
    dev = resolve_device("cpu" if args.cpu else args.device)
    E, S, T = args.eval_scenes, args.eval_starts, args.eval_steps
    prs = Pairs(E, S, dev)
    teacher_pkl, teacher_data = teacher_files(args.teacher)
    tpacked = pack_unet(load_quadrotor_teacher(teacher_pkl, device=dev), dev)
    made = None
    if args.make:
        made = make_student(tpacked, load_pool(teacher_data, dev), out_path.parent, dev,
                            args.n_sample_chunks, args.chunk_rows, args.finetune_steps,
                            args.chunk, args.batch_size, args.finetune_lr, args.guide_scale,
                            args.t_start_guide, args.clear_margin, args.progress_keep,
                            log=lambda m: print(m, flush=True), seed=args.seed)
        spacked, warm_err = pack_unet(made["student"], dev), made["warm_err"]
    else:
        spacked = pack_unet(load_scene_student(args.student, device=dev), dev)
        warm_err = widened_teacher(tpacked.model, dev)[1]
    protocol = ((E, S, T, args.guide_scale, args.t_start_guide)
                == (gys.N_SCENES, gys.N_STARTS, gys.N_STEPS, gys.GUIDE_SCALE, gys.T_START_SCENE))
    key_seed = gys.SCENE_KEY_SEED + SEED_STRIDE * args.seed
    noise = start_noise(len(prs), T, 1, dev, seed=key_seed)
    held_out, scene0, clear0 = {}, {}, {}
    rows = (("teacher_scene_blind", "blind", False), ("teacher_per_scene_guided_oracle", "oracle",
                                                      True))
    for key, ys_row, guided in () if args.no_teacher_rows else rows:
        loop, route = teacher_loop(tpacked, prs.centers, prs.radii, T, dev, guided,
                                   args.guide_scale, args.t_start_guide)
        xt, seconds, launches = _run(loop, route, prs.x0, noise, dev)
        held_out[key] = dict(prs.metrics(xt), seconds=seconds, launches=launches,
                             kernel="fused_unet" if guided else "cfg_chain")
        m0 = track_metrics(xt[:S], centers=prs.scene_centers[0], radii=prs.scene_radii[0])
        clear0[ys_row] = min_clearance(xt[:S], prs.scene_centers[0], prs.scene_radii[0])
        scene0[key] = dict(m0, within_yardstick=gys.within(m0, ys_row) if protocol else None,
                           yardstick_gaps=gys.gaps(m0, ys_row))
        print(json.dumps({key: held_out[key], "scene0": scene0[key]}), flush=True)
    if len(clear0) == 2 and S == gys.N_STARTS:
        stats = gys.paired(clear0["oracle"], clear0["blind"])
        scene0["paired_gate"] = dict(stats, within=gys.paired_within(stats, "scene0")
                                     if protocol else None)
    for k in sorted({1, args.select_k}):
        key = "scene_conditioned_student" + ("" if k == 1 else f"_k{k}")
        loop, chain = student_loop(spacked, prs.centers, prs.radii, T, dev, k)
        nz = noise if k == 1 else start_noise(len(prs), T, k, dev, seed=key_seed)
        xt, seconds, launches = _run(loop, chain, prs.x0, nz, dev)
        del nz
        held_out[key] = dict(prs.metrics(xt), seconds=seconds, launches=launches,
                             kernel="cfg_chain")
        print(json.dumps({key: held_out[key]}), flush=True)
    cc = torch.from_numpy(np.tile(OBS_CENTERS[None], (S, 1, 1))).to(dev)
    cr = torch.from_numpy(np.tile(OBS_RADII[None], (S, 1))).to(dev)
    loop, chain = student_loop(spacked, cc, cr, T, dev)
    xt, seconds, launches = _run(loop, chain, prs.x0[:S],
                                 start_noise(S, T, 1, dev, seed=47 + SEED_STRIDE * args.seed), dev)
    canon = dict(track_metrics(xt), seconds=seconds, launches=launches)
    print(json.dumps({"canonical_scene_student": canon}), flush=True)
    keys = made["keys"] if made else dict.fromkeys(
        ("n_kept", "n_drawn", "sample_seconds", "finetune_steps", "finetune_seconds",
         "final_loss"))
    out = {"method": "scene-conditioned guided-data fine-tune (widened context)",
           "teacher": args.teacher, "student": made["making"]["student_path"] if made
           else args.student, "guide_scale": args.guide_scale,
           "t_start_guide": args.t_start_guide, "w": args.w, "clear_margin": args.clear_margin,
           "progress_keep": args.progress_keep, "select_k": args.select_k, "seed": args.seed,
           **keys,
           "warm_start_max_err": warm_err, "eval_scenes": E, "eval_starts": S, "eval_steps": T,
           "held_out": held_out, "canonical_scene_student": canon, "scene0_yardstick": scene0,
           "making": made["making"] if made else None, "device": str(dev),
           "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if dev.type == "cuda":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=2))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
