"""Best-of-K self-distillation of the scene-conditioned quadrotor student
across the scene distribution, on the card: the port of the JAX package's
``scripts/onpolicy_scene.py``, its flags (``:45-99``), report keys and rows.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.onpolicy_scene \\
        [--scene-dir DIR] [--init-student PKL] [--iterations 2] [--collect-scenes 16] \\
        [--collect-starts 8] [--label-k 16] [--train-steps 4000] [--lqr-candidate] \\
        [--device cuda] [--out DIR]

Each iteration gi (= the iteration plus ``--iter-offset``):

1. Collection: ``--collect-scenes`` scenes (``sample_scenes(M, seed=500 +
   gi)``) x ``--collect-starts`` starts (``eval_start_states(S, seed=60 +
   gi)``), every pair one episode of ``--collect-steps`` replans of the
   current student at K = ``--label-k`` with its scene's safety-first
   selection (``scene_conditioned_quadrotor.student_loop``: the batched
   ``make_closed_loop``, the CFG chain kernel at N K samples), in chunks of
   ``--collect-chunk`` episodes, each episode's noise in turn from
   ``torch.Generator(device).manual_seed(300 + gi)``. The visited states
   that are finite and below 100 in every entry are kept, each with its
   episode's scene.
2. Labels: for 256 rows at a time, K candidates per row from the student,
   each row with its own 24-dim context, through the CFG chain kernel at 256
   K samples (noise from ``manual_seed(400 + gi)``), the LQR hover plan
   appended with ``--lqr-candidate``; each candidate scored by its rollout's
   task cost plus ``1e5 pen + 1e5 pen^2``, pen = max(``--label-margin`` -
   clearance from the row's scene, 0). A non-finite score becomes +inf and
   the first smallest wins: the JAX script's own rule (there a NaN would win
   ``jnp.argmin``), not the runtime's (:func:`pick`).
3. Training: ``--train-steps`` steps from the current student with a fresh
   Adam state (lr ``--lr``, the EMA from step 0 at every step), in chunks of
   ``--chunk`` at batch ``--batch-size``; the chunks at
   ``round(linspace(0, n_chunks - 1, n_onp))``, n_onp = ``--onpolicy-frac``
   n_chunks, draw from the on-policy pool (every iteration's labels so far),
   the others from ``--scene-dir``'s ``scene_dataset.npz``; draws from
   ``manual_seed(77 + gi)``. The EMA weights are the next student.

Then the first and the last student fly the committed held-out protocol
(``--eval-scenes`` scenes of ``sample_scenes(n, seed=99)`` x
``--eval-starts`` starts of ``eval_start_states(n, seed=11)``, ``--steps``
replans, and ``--eval-steps-long`` too when given) at K = 1 and
``--label-k``, one scene per call as the JAX script dispatches it, each
pair's noise in turn from ``manual_seed(31)``. JAX's keys cannot be
reproduced in torch, so every draw is a torch generator's.

``--scene-dir`` (``artifacts/scene_conditioned`` by default) holds the
first student ``scene_student_ema.pkl`` (unless ``--init-student``) and the
mixed-in dataset; a directory that ``scene_conditioned_quadrotor --make``
wrote serves as well. The new student (``scene_student_ema.pkl``, the JAX
package's layout) and ``report.json`` go to ``--out``
(``chiprun_out/onpolicy_scene`` by default), never under ``artifacts/``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Set

import numpy as np
import torch

from ..core.schedules import make_schedule
from ..data import guided_yardstick as gys
from ..data.normalization import normalize, unnormalize
from ..data.scene_stats import scene_stats
from ..diffusion.gaussian_diffusion import GaussianDiffusion
from ..dynamics.base import rollout_with_cost
from ..dynamics.quadrotor import quadrotor, quadrotor_cost
from ..models.temporal_unet import TemporalUnet
from ..models.weights import SCENE_STUDENT_CONFIG, load_scene_student
from ..ops.fused_denoise import make_fused_cfg_chain
from ..ops.unet_pack import PackedUnet, pack_unet
from ..train.trainer import make_optimizer, make_scanned_train_steps, make_train_step
from ..utils.device import resolve_device
from .quadrotor_task import (eval_start_states, make_lqr_hover_plan, min_clearance_torch,
                             sample_scenes, scene_features, track_metrics)
from .scene_conditioned_quadrotor import (HORIZON, SEED_STRIDE, new_train_state, save_student,
                                          student_loop)

__all__ = ["LABEL_ROWS", "pick", "label_scores", "Labeler", "collect", "onpolicy_slots",
           "train_iteration", "evaluate", "main"]

ROOT = Path(__file__).resolve().parents[2]
LABEL_ROWS = 256  # rows per labeler batch (the JAX script's CH)
N_NOISE = gys.T + gys.N_TAIL + 1


def pick(scores: torch.Tensor) -> torch.Tensor:
    """The labeler's choice per row of scores (R, C): a non-finite score
    becomes +inf, then the first smallest (so a NaN never wins, and a row
    whose every score is non-finite takes its first candidate)."""
    return torch.argmin(torch.where(torch.isfinite(scores), scores,
                                    torch.full_like(scores, float("inf"))), dim=1)


def label_scores(plans: torch.Tensor, x0: torch.Tensor, centers: torch.Tensor,
                 radii: torch.Tensor, margin: float) -> torch.Tensor:
    """(R, C) curation scores of candidates ``plans`` (R, C, H, 4)
    (normalized) from the rows' states x0 (R, 12) in their scenes (centers
    (R, 3, 3), radii (R, 3)): the rollout's quadratic task cost plus ``1e5
    pen + 1e5 pen^2``, pen = max(margin - clearance, 0)."""
    ins = scene_stats()[0].to(plans.device)
    u = unnormalize(ins, torch.clamp(plans, -1.0, 1.0))
    xs, c = rollout_with_cost(quadrotor(), quadrotor_cost().to(plans.device),
                              x0[:, None].expand(-1, plans.shape[1], -1), u)
    clear = min_clearance_torch(xs, centers[:, None], radii[:, None])
    pen = torch.clamp(margin - clear, min=0.0)
    return c + 1e5 * pen + 1e5 * pen * pen


class Labeler:
    """Best-of-K labels at (state, scene) rows: ``rows`` rows per batch, K
    candidates each through ``chain``, the CFG chain kernel at rows K
    samples, the LQR hover plan appended when ``lqr_plan``."""

    def __init__(self, packed: PackedUnet, k: int, rows: int, device, margin: float = 0.0,
                 lqr_plan: Optional[Callable] = None):
        self.k, self.rows, self.margin, self.lqr_plan = k, rows, margin, lqr_plan
        self.device = resolve_device(device)
        self.chain = make_fused_cfg_chain(
            packed, make_schedule("exponential", gys.T), n_samples=rows * k, w=gys.W,
            n_tail=gys.N_TAIL, device=self.device)
        self.cond = scene_stats()[1].to(self.device)

    def context(self, x0: torch.Tensor, centers: torch.Tensor, radii: torch.Tensor):
        """The rows' 24-dim normalized context, (R, 24)."""
        return normalize(self.cond, torch.cat([x0, scene_features(centers, radii).to(x0.device)],
                                              dim=-1))

    def candidates(self, x0, centers, radii, noise, sample=None) -> torch.Tensor:
        """(rows, K (+1), H, 4): each row's K samples of ``sample`` (the
        chain unless given, e.g. its ``plain``) on ``noise`` (n_total + 1,
        rows K, H, 4), then the LQR plan."""
        sample = sample if sample is not None else self.chain
        ctx = self.context(x0, centers, radii).repeat_interleave(self.k, dim=0)
        plans = sample(ctx, noise).reshape(self.rows, self.k, HORIZON, 4)
        if self.lqr_plan is not None:
            plans = torch.cat([plans, self.lqr_plan(x0)[:, None]], dim=1)
        return plans

    def batch(self, x0, centers, radii, noise, sample=None):
        """(labels (rows, H, 4), picks (rows,), scores (rows, C), candidates
        (rows, C, H, 4)) of one batch."""
        plans = self.candidates(x0, centers, radii, noise, sample)
        scores = label_scores(plans, x0, centers, radii, self.margin)
        choice = pick(scores)
        return (plans[torch.arange(self.rows, device=plans.device), choice], choice, scores,
                plans)

    def __call__(self, x0: torch.Tensor, centers: torch.Tensor, radii: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        """Labels (n, H, 4) of n rows, batch by batch (the last padded with
        its last row), each batch's noise in turn from ``generator``."""
        out, n = [], x0.shape[0]
        for i in range(0, n, self.rows):
            sl = [t[i:i + self.rows] for t in (x0, centers, radii)]
            m = sl[0].shape[0]
            if m < self.rows:
                sl = [torch.cat([t, t[-1:].expand(self.rows - m, *t.shape[1:])]) for t in sl]
            noise = torch.randn((N_NOISE, self.rows * self.k, HORIZON, 4), generator=generator,
                                device=self.device)
            out.append(self.batch(*sl, noise)[0][:m])
        return torch.cat(out) if out else torch.zeros((0, HORIZON, 4), device=self.device)


def collect(packed: PackedUnet, centers: torch.Tensor, radii: torch.Tensor, starts: torch.Tensor,
            n_steps: int, k: int, chunk: int, device, generator: torch.Generator):
    """(visited states (N, n_steps, 12), chain launches): the student's
    episodes at K with their scenes' selection, ``chunk`` episodes per
    batched loop, each episode's noise in turn from ``generator``."""
    dev = resolve_device(device)
    tracks, launches = [], 0
    for i in range(0, starts.shape[0], chunk):
        c, r, x0 = centers[i:i + chunk], radii[i:i + chunk], starts[i:i + chunk]
        loop, chain = student_loop(packed, c, r, n_steps, dev, k)
        noise = torch.stack([torch.randn((n_steps, N_NOISE, k, HORIZON, 4), generator=generator,
                                         device=dev) for _ in range(x0.shape[0])])
        chain.launches = 0
        tracks.append(loop(x0, noise).x_track[:, :-1])
        launches += chain.launches
        del noise
    return torch.cat(tracks), launches


def onpolicy_slots(n_chunks: int, frac: float) -> Set[int]:
    """The chunks that draw from the on-policy pool: ``round(linspace(0,
    n_chunks - 1, n_onp))``, n_onp = round(frac n_chunks)."""
    n_onp = int(round(frac * n_chunks))
    if not n_onp:
        return set()
    return set(np.round(np.linspace(0, n_chunks - 1, n_onp)).astype(int).tolist())


def train_iteration(model: TemporalUnet, onp_u, onp_c, mix_u, mix_c, n_steps: int, chunk: int,
                    batch_size: int, lr: float, frac: float, generator: torch.Generator) -> dict:
    """One iteration's fine-tune from ``model``'s weights: a fresh Adam
    state, the EMA from step 0 at every step. Returns the next ``student``
    (the EMA weights) and the chunks' mean losses by pool."""
    diffusion = GaussianDiffusion(make_schedule("exponential", gys.T)).to(onp_u.device)
    opt = make_optimizer(lr)
    chunk_fn = make_scanned_train_steps(
        make_train_step(diffusion, model, opt, step_start_ema=0, update_ema_every=1), chunk)
    state = new_train_state(model, opt)
    n_chunks = n_steps // chunk
    slots = onpolicy_slots(n_chunks, frac)
    losses: Dict[str, List[torch.Tensor]] = {"onp": [], "ds": []}
    for c in range(n_chunks):
        on = c in slots
        state, loss = chunk_fn(state, onp_u if on else mix_u, onp_c if on else mix_c, batch_size,
                               generator)
        losses["onp" if on else "ds"].append(loss)
    student = TemporalUnet(**SCENE_STUDENT_CONFIG, cfg_indicator=True).to(onp_u.device).eval()
    student.load_state_dict(state.layout.views(state.ema_params))
    return {"student": student, "state": state, "slots": sorted(slots),
            "losses": {k: [float(v) for v in vs] for k, vs in losses.items()}}


def evaluate(packed: PackedUnet, k: int, n_steps: int, n_scenes: int, n_starts: int,
             device, seed: int = gys.SCENE_KEY_SEED) -> dict:
    """The held-out protocol at K, one batched loop per scene: the pairs'
    ``track_metrics`` against their scenes, ``per_scene_cf``, the seconds and
    the chain's launches."""
    dev = resolve_device(device)
    ev_c, ev_r = sample_scenes(n_scenes, seed=gys.SCENE_SEED)
    starts = torch.from_numpy(eval_start_states(n_starts, seed=gys.SCENE_START_SEED)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tracks, launches, t0 = [], 0, time.perf_counter()
    for e in range(n_scenes):
        c = torch.from_numpy(np.repeat(ev_c[e:e + 1], n_starts, axis=0)).to(dev)
        r = torch.from_numpy(np.repeat(ev_r[e:e + 1], n_starts, axis=0)).to(dev)
        loop, chain = student_loop(packed, c, r, n_steps, dev, k)
        noise = torch.stack([torch.randn((n_steps, N_NOISE, k, HORIZON, 4), generator=gen,
                                         device=dev) for _ in range(n_starts)])
        chain.launches = 0
        tracks.append(loop(starts, noise).x_track.cpu().numpy())
        launches += chain.launches
        del noise
    xt = np.concatenate(tracks)
    m = track_metrics(xt, centers=np.repeat(ev_c, n_starts, axis=0),
                      radii=np.repeat(ev_r, n_starts, axis=0))
    m["per_scene_cf"] = [track_metrics(xt[e * n_starts:(e + 1) * n_starts], centers=ev_c[e],
                                       radii=ev_r[e])["collision_free_fraction"]
                         for e in range(n_scenes)]
    return dict(m, seconds=time.perf_counter() - t0, launches=launches)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scene-dir", default=str(ROOT / "artifacts" / "scene_conditioned"))
    p.add_argument("--teacher", default=str(gys.TEACHER.parent),
                   help="the statistics' source; the port reads data/quadrotor_stats.py")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "onpolicy_scene"))
    p.add_argument("--horizon", type=int, default=HORIZON, choices=[HORIZON])
    p.add_argument("--steps", type=int, default=gys.N_STEPS)
    p.add_argument("--collect-scenes", type=int, default=16)
    p.add_argument("--collect-starts", type=int, default=8)
    p.add_argument("--collect-steps", type=int, default=None)
    p.add_argument("--lqr-candidate", action="store_true")
    p.add_argument("--collect-chunk", type=int, default=256)
    p.add_argument("--eval-steps-long", type=int, default=0)
    p.add_argument("--label-k", type=int, default=16)
    p.add_argument("--label-margin", type=float, default=0.0)
    p.add_argument("--train-steps", type=int, default=4000)
    p.add_argument("--iterations", type=int, default=2)
    p.add_argument("--chunk", type=int, default=250)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--onpolicy-frac", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--w", type=float, default=gys.W, choices=[gys.W])
    p.add_argument("--eval-scenes", type=int, default=gys.N_SCENES)
    p.add_argument("--eval-starts", type=int, default=gys.N_STARTS)
    p.add_argument("--init-student", default=None)
    p.add_argument("--iter-offset", type=int, default=0)
    p.add_argument("--seed", type=int, default=0,
                   help=f"moves every torch seed by {SEED_STRIDE} x this (0: the JAX script's)")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--device", default=None, help="cuda unless given")
    args = p.parse_args(argv)
    out_dir = Path(args.out).resolve()
    if (ROOT / "artifacts") in [out_dir, *out_dir.parents]:
        raise SystemExit(f"--out {args.out}: the student goes under chiprun_out/, not artifacts/")
    dev = resolve_device("cpu" if args.cpu else args.device)
    log = lambda m: print(m, flush=True)
    scene_dir = Path(args.scene_dir)
    with np.load(scene_dir / "scene_dataset.npz") as mix:
        mix_u = torch.from_numpy(mix["inputs_normalized"]).to(dev)
        mix_c = torch.from_numpy(mix["condition_normalized"]).to(dev)
    init_path = args.init_student or str(scene_dir / "scene_student_ema.pkl")
    student0 = load_scene_student(init_path, device=dev)
    ins = scene_stats()[0]
    lqr = (make_lqr_hover_plan(quadrotor(), quadrotor_cost(), ins, HORIZON, dev)
           if args.lqr_candidate else None)
    E, S, K = args.eval_scenes, args.eval_starts, args.label_k
    collect_steps = args.collect_steps or args.steps
    off = SEED_STRIDE * args.seed
    report = {
        "protocol": f"{E} held-out scenes (seed 99) x {S} starts x {args.steps} steps, noise "
                    f"torch.Generator seed 31 - the committed scene_conditioned eval",
        "init_student": init_path, "iter_offset": args.iter_offset, "seed": args.seed,
        "label_margin": args.label_margin, "label_k": K, "w": args.w,
        "collect_steps": collect_steps, "lqr_candidate": bool(args.lqr_candidate),
        "collect": {"scenes_per_iter": args.collect_scenes,
                    "starts_per_scene": args.collect_starts, "iterations": args.iterations},
        "train": {"steps_per_iteration": args.train_steps,
                  "total_steps": args.train_steps * args.iterations, "lr": args.lr,
                  "onpolicy_frac": args.onpolicy_frac},
        "iterations": [], "rows": [], "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if dev.type == "cuda":
        report["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    out_dir.mkdir(parents=True, exist_ok=True)
    cond = scene_stats()[1].to(dev)
    cur = student0
    pool_u: List[torch.Tensor] = []
    pool_c: List[torch.Tensor] = []
    for it in range(args.iterations):
        gi = it + args.iter_offset
        t0 = time.perf_counter()
        M, S2 = args.collect_scenes, args.collect_starts
        cc, cr = sample_scenes(M, seed=500 + gi)
        col_c = torch.from_numpy(np.repeat(cc, S2, axis=0)).to(dev)
        col_r = torch.from_numpy(np.repeat(cr, S2, axis=0)).to(dev)
        col_x = torch.from_numpy(np.tile(eval_start_states(S2, seed=60 + gi), (M, 1))).to(dev)
        packed = pack_unet(cur, dev)
        visited, c_launches = collect(packed, col_c, col_r, col_x, collect_steps, K,
                                      args.collect_chunk, dev,
                                      torch.Generator(device=dev).manual_seed(300 + gi + off))
        T = visited.shape[1]
        vx = visited.reshape(-1, 12)
        vc = col_c.repeat_interleave(T, dim=0)
        vr = col_r.repeat_interleave(T, dim=0)
        ok = torch.isfinite(vx).all(-1) & (vx.abs() < 100.0).all(-1)
        vx, vc, vr = vx[ok], vc[ok], vr[ok]
        n_drop = int((~ok).sum())
        t_collect = time.perf_counter() - t0
        log(f"[it {it}] collect: {vx.shape[0]} (state, scene) pairs from {M} scenes ({n_drop} "
            f"diverged dropped, {t_collect:.0f}s)")
        t1 = time.perf_counter()
        labeler = Labeler(packed, K, min(LABEL_ROWS, max(1, vx.shape[0])), dev,
                          args.label_margin, lqr)
        labeler.chain.launches = 0
        labels = labeler(vx, vc, vr, torch.Generator(device=dev).manual_seed(400 + gi + off))
        l_launches = labeler.chain.launches
        ctx24 = normalize(cond, torch.cat([vx, scene_features(vc, vr).to(dev)], dim=-1))
        lab_ok = torch.isfinite(labels).all(-1).all(-1)
        pool_u.append(torch.clamp(labels[lab_ok], -1.0, 1.0))
        pool_c.append(ctx24[lab_ok])
        onp_u, onp_c = torch.cat(pool_u), torch.cat(pool_c)
        t_label = time.perf_counter() - t1
        log(f"[it {it}] label: best-of-{K} at {labels.shape[0]} pairs ({t_label:.0f}s)")
        t2 = time.perf_counter()
        tr = train_iteration(cur, onp_u, onp_c, mix_u, mix_c, args.train_steps, args.chunk,
                             args.batch_size, args.lr, args.onpolicy_frac,
                             torch.Generator(device=dev).manual_seed(77 + gi + off))
        cur = tr["student"]
        t_train = time.perf_counter() - t2
        rng = lambda v: f"{v[0]:.4f}->{v[-1]:.4f}" if v else "n/a"
        log(f"[it {it}] train {args.train_steps} steps ({t_train:.0f}s): onp "
            f"{rng(tr['losses']['onp'])}, ds {rng(tr['losses']['ds'])}")
        report["iterations"].append({
            "pairs": int(vx.shape[0]), "dropped": n_drop, "labels_kept": int(lab_ok.sum()),
            "pool": int(onp_u.shape[0]), "collect_seconds": t_collect,
            "collect_launches": c_launches, "label_seconds": t_label,
            "label_launches": l_launches, "train_seconds": t_train, "slots": tr["slots"],
            "losses": tr["losses"]})
    save_student(out_dir / "scene_student_ema.pkl", cur)
    eval_lengths = [args.steps] + ([args.eval_steps_long] if args.eval_steps_long else [])
    for tag, model in (("before", student0), ("onpolicy", cur)):
        packed = pack_unet(model, dev)
        for steps in eval_lengths:
            for k in (1, K):
                row = {"student": tag, "K": k, "steps": steps,
                       **evaluate(packed, k, steps, E, S, dev, gys.SCENE_KEY_SEED + off)}
                report["rows"].append(row)
                log(json.dumps(row))
                (out_dir / "report.json").write_text(json.dumps(report, indent=2))
    (out_dir / "report.json").write_text(json.dumps(report, indent=2))
    log(json.dumps({k: v for k, v in report.items() if k != "rows"}))
    return report


if __name__ == "__main__":
    main()
