"""The scene-conditioned quadrotor study's held-out evaluation on the card:
the port of step 4 of the JAX package's
``scripts/scene_conditioned_quadrotor.py`` (``:278-395``), its rows and JSON
keys, and of its ``widen_film_params`` (``:48-74``) with the warm-start check.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.scene_conditioned_quadrotor \\
        [--eval-scenes 8] [--eval-starts 16] [--eval-steps 60] [--select-k 16] \\
        [--guide-scale 0.1] [--t-start-guide 6.25] [--device cuda] [--out PATH]

Every (scene, start) pair of ``--eval-scenes`` held-out scenes
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
- ``scene_conditioned_student``: the scene student
  (``artifacts/scene_conditioned/scene_student_ema.pkl``, context 24: the
  state followed by the pair's scene features), through the chain at N;
- ``scene_conditioned_student_k{K}``: the same at K = ``--select-k``
  candidates scored by the pair's scene's safety-first selection cost
  (``make_select_cost(quad_cost, centers, radii)``), the chain at N K;
- ``canonical_scene_student``: the student on the canonical scene from the
  starts alone (noise seed 47).

Each held-out row has ``track_metrics`` against its pairs' scenes,
``per_scene_cf`` and the seconds and kernel launches it took. The rows of
the scene-blind teacher and of the oracle also carry, in
``scene0_yardstick``, their first 16 pairs' (scene 0's) metrics and whether
they lie within ``data/guided_yardstick.py``'s bounds (only when the
protocol is the yardstick's). ``warm_start_max_err`` is the widened
teacher's largest gap from the teacher on the JAX script's probe.

Steps 1-3 of the JAX script (the guided scene data, the widening's
fine-tune, 30,000 steps) refuse: they are the scene study's making half,
next in ROADMAP.md A3. The report goes to ``--out``
(``chiprun_out/scene_conditioned_quadrotor/report.json`` by default), never
under ``artifacts/``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Mapping

import numpy as np
import torch

from ..data import guided_yardstick as gys
from ..data import scene_yardstick as sys_
from ..data.normalization import NormalizerStats
from ..data.quadrotor_stats import quadrotor_stats
from ..data.scene_stats import scene_stats
from ..dynamics.base import Plant
from ..dynamics.quadrotor import quadrotor, quadrotor_cost
from ..models.temporal_unet import TemporalUnet
from ..models.weights import SCENE_STUDENT_CONFIG, load_quadrotor_teacher, load_scene_student
from ..ops.unet_pack import PackedUnet, pack_unet
from ..utils.device import resolve_device
from .bench_scene_student import start_noise
from .flagship_quadrotor import serving_loop
from .quadrotor_task import (OBS_CENTERS, OBS_RADII, eval_start_states, make_penalty_grad,
                             make_select_cost, rows_of, sample_scenes, scene_features,
                             track_metrics)

__all__ = ["widen_film_params", "warm_start_error", "Pairs", "scene_guide_builder",
           "SceneSelectCost", "row_features", "teacher_loop", "student_loop", "main"]

ROOT = Path(__file__).resolve().parents[2]


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
    p.add_argument("--teacher", default=str(gys.TEACHER))
    p.add_argument("--student", default=str(sys_.STUDENT))
    p.add_argument("--w", type=float, default=gys.W, choices=[gys.W])
    p.add_argument("--guide-scale", type=float, default=gys.GUIDE_SCALE)
    p.add_argument("--t-start-guide", type=float, default=gys.T_START_SCENE)
    p.add_argument("--select-k", type=int, default=16)
    p.add_argument("--eval-scenes", type=int, default=gys.N_SCENES)
    p.add_argument("--eval-starts", type=int, default=gys.N_STARTS)
    p.add_argument("--eval-steps", type=int, default=gys.N_STEPS)
    for flag in ("--sample", "--finetune"):
        p.add_argument(flag, action="store_true", help="refused: the study's making half")
    p.add_argument("--device", default=None, help="cuda unless given")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "scene_conditioned_quadrotor" /
                                        "report.json"))
    args = p.parse_args(argv)
    if args.sample or args.finetune:
        raise SystemExit("steps 1-3 (the guided scene data, the widening's fine-tune) are the "
                         "scene study's making half, which the port does not have yet "
                         "(ROADMAP.md A3)")
    out_path = Path(args.out).resolve()
    if (ROOT / "artifacts") in out_path.parents:
        raise SystemExit(f"--out {args.out}: the report goes under chiprun_out/, not artifacts/")
    dev = resolve_device(args.device)
    E, S, T = args.eval_scenes, args.eval_starts, args.eval_steps
    prs = Pairs(E, S, dev)
    tpacked = pack_unet(load_quadrotor_teacher(args.teacher, device=dev), dev)
    spacked = pack_unet(load_scene_student(args.student, device=dev), dev)
    widened = TemporalUnet(**SCENE_STUDENT_CONFIG, cfg_indicator=True).to(dev).eval()
    widened.load_state_dict(widen_film_params(tpacked.model.state_dict(), widened.state_dict(),
                                              12, 24, cfg_indicator=True))
    warm_err = warm_start_error(tpacked.model, widened)
    if not warm_err < 1e-5:
        raise RuntimeError(f"widening surgery broke the warm start: {warm_err}")
    protocol = ((E, S, T, args.guide_scale, args.t_start_guide)
                == (gys.N_SCENES, gys.N_STARTS, gys.N_STEPS, gys.GUIDE_SCALE, gys.T_START_SCENE))
    noise = start_noise(len(prs), T, 1, dev, seed=gys.SCENE_KEY_SEED)
    held_out, scene0 = {}, {}
    rows = (("teacher_scene_blind", "blind", False), ("teacher_per_scene_guided_oracle", "oracle",
                                                      True))
    for key, ys_row, guided in rows:
        loop, route = teacher_loop(tpacked, prs.centers, prs.radii, T, dev, guided,
                                   args.guide_scale, args.t_start_guide)
        xt, seconds, launches = _run(loop, route, prs.x0, noise, dev)
        held_out[key] = dict(prs.metrics(xt), seconds=seconds, launches=launches,
                             kernel="fused_unet" if guided else "cfg_chain")
        m0 = track_metrics(xt[:S], centers=prs.scene_centers[0], radii=prs.scene_radii[0])
        scene0[key] = dict(m0, within_yardstick=gys.within(m0, ys_row) if protocol else None,
                           yardstick_gaps=gys.gaps(m0, ys_row))
        print(json.dumps({key: held_out[key], "scene0": scene0[key]}), flush=True)
    for k in sorted({1, args.select_k}):
        key = "scene_conditioned_student" + ("" if k == 1 else f"_k{k}")
        loop, chain = student_loop(spacked, prs.centers, prs.radii, T, dev, k)
        nz = noise if k == 1 else start_noise(len(prs), T, k, dev, seed=gys.SCENE_KEY_SEED)
        xt, seconds, launches = _run(loop, chain, prs.x0, nz, dev)
        del nz
        held_out[key] = dict(prs.metrics(xt), seconds=seconds, launches=launches,
                             kernel="cfg_chain")
        print(json.dumps({key: held_out[key]}), flush=True)
    cc = torch.from_numpy(np.tile(OBS_CENTERS[None], (S, 1, 1))).to(dev)
    cr = torch.from_numpy(np.tile(OBS_RADII[None], (S, 1))).to(dev)
    loop, chain = student_loop(spacked, cc, cr, T, dev)
    xt, seconds, launches = _run(loop, chain, prs.x0[:S], start_noise(S, T, 1, dev, seed=47), dev)
    canon = dict(track_metrics(xt), seconds=seconds, launches=launches)
    print(json.dumps({"canonical_scene_student": canon}), flush=True)
    out = {"method": "scene-conditioned guided-data fine-tune (widened context)",
           "teacher": args.teacher, "student": args.student, "guide_scale": args.guide_scale,
           "t_start_guide": args.t_start_guide, "w": args.w, "select_k": args.select_k,
           "n_kept": None, "n_drawn": None, "sample_seconds": None, "finetune_steps": None,
           "finetune_seconds": None, "final_loss": None, "warm_start_max_err": warm_err,
           "eval_scenes": E, "eval_starts": S, "eval_steps": T, "held_out": held_out,
           "canonical_scene_student": canon, "scene0_yardstick": scene0, "device": str(dev),
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
