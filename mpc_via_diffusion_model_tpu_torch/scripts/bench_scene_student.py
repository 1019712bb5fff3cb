"""The scene-conditioned quadrotor student's serving path on the card: the
port of the JAX package's ``scripts/bench_scene_student.py``, its flags,
rows and JSON keys, plus ``--device``, an ``xla_k{K}`` row and
``within_yardstick`` on each row.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.bench_scene_student \\
        [--scene-index 0] [--eval-starts 16] [--steps 60] [--candidates 1 16] \\
        [--device cuda] [--out PATH]

One student that plans around any obstacle layout
(``artifacts/scene_conditioned/scene_student_ema.pkl``, context 24: the
12-state followed by the scene's 12 features; the statistics of
``data/scene_stats.py``) flies ``--steps`` replans through held-out scene
``--scene-index`` of ``sample_scenes(index + 1, seed=99)`` from each of the
``--eval-starts`` starts ``eval_start_states(n, seed=11)``, T = 25 + 5, w =
0.01. For each K of ``--candidates``:

- ``k{K}``: the whole closed loop as one launch of the CFG episode kernel's
  quadrotor entry (``cfg_episode_quadrotor``: the context map
  ``ConcatFeatures`` and, at K > 1, the scene's safety-first scorer
  ``make_select_cost(quad_cost, centers, radii)`` inside the kernel, the
  scene in its consts table), the ``track_metrics`` of its tracks against
  the scene; ``k{K}_hz_pipelined``: episodes issued back to back, one
  synchronise per batch, best of the batches (``eval/timing.py``);
  ``k{K}_hz_sustained``: a dependent chain of ``N_CHUNKS`` episodes, each
  starting where the last ended, best of ``N_REPS`` after a warm-up chain;
- ``xla_k{K}``: the same policy through the per-replan loop
  (``make_closed_loop`` with ``state_to_condition`` and the CFG chain kernel
  as ``sample_override``, best-of-K scored on the host), on the same noise,
  for parity with the episode (``k{K}_vs_xla_max_err``: the first start's
  tracks), and ``xla_k{K}_hz``, its replans per second over that run.

Each start's noise is drawn in turn from ``torch.Generator(device)
.manual_seed(31)`` (the JAX script splits ``PRNGKey(31)``): (steps, 31, K,
48, 4), ``ddpm_cfg_sample``'s layout per replan. Rows at K = 1 and K = 16
carry ``within_yardstick`` (with the gaps): whether their metrics lie within
``data/scene_yardstick.py``'s bounds of the JAX package's on the CPU; None
where the protocol differs from the yardstick's (scene, starts, replans).

Cuts from the JAX script's protocol, so that the default run takes about 5
minutes of an H100 (a K = 16 episode of 60 replans takes ~8 s there, its
candidates one after another):

- at K > 1 the sustained chain is ``max(1, N_CHUNKS // K)`` episodes long,
  best of one after the warm-up chain (the JAX script: 10 chained episodes,
  best of 3, at every K);
- at K > 1 the pipelined rate issues ``max(2, N_PIPELINED // K)`` episodes
  in one batch after a warm-up episode (the JAX script: 8, best of 3
  batches).

The report goes to ``--out`` (``chiprun_out/bench_scene_student.json`` by
default), never under ``artifacts/``; each K's row is also printed as a JSON
line, as the JAX script prints it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from pathlib import Path
from typing import List, Union

import torch

from ..control.conditions import ConcatFeatures
from ..control.runtime import make_closed_loop
from ..core.schedules import make_schedule
from ..data import scene_yardstick as sys_
from ..data.scene_stats import scene_stats
from ..diffusion.gaussian_diffusion import GaussianDiffusion
from ..dynamics.quadrotor import quadrotor, quadrotor_cost
from ..eval.timing import pipelined_time_fn
from ..models.temporal_unet import TemporalUnet
from ..models.weights import load_scene_student
from ..ops.fused_denoise import make_fused_cfg_chain
from ..ops.fused_episode import FusedCfgEpisode, make_fused_cfg_episode
from ..ops.unet_pack import PackedUnet, pack_unet
from ..utils.device import resolve_device
from .quadrotor_task import (eval_start_states, make_select_cost, sample_scenes, scene_features,
                             track_metrics)

__all__ = ["Scene", "scene", "episode", "chain_loop", "start_noise", "yardstick", "main"]

ROOT = Path(__file__).resolve().parents[2]
HORIZON = 48
# the JAX script's rate protocol at K = 1: 10 chained episodes, best of 3; 8 pipelined episodes
N_CHUNKS, N_REPS, N_PIPELINED = 10, 3, 8


@dataclasses.dataclass
class Scene:
    """One held-out scene on a device, and what its serving path needs."""

    index: int
    centers: torch.Tensor        # (3, 3)
    radii: torch.Tensor          # (3,)
    to_cond: ConcatFeatures      # x -> [x, scene_features]
    select_cost: object          # the scene's safety-first selection cost


def scene(index: int, device) -> Scene:
    """Held-out scene ``index`` of ``sample_scenes(index + 1, seed=99)`` on ``device``."""
    c, r = sample_scenes(index + 1, seed=sys_.SCENE_SEED)
    cen, rad = torch.from_numpy(c[index]).to(device), torch.from_numpy(r[index]).to(device)
    return Scene(index, cen, rad, ConcatFeatures(scene_features(cen, rad)).to(device),
                 make_select_cost(quadrotor_cost(), centers=cen, radii=rad).to(device))


def episode(model: Union[TemporalUnet, PackedUnet], sc: Scene, k: int, n_steps: int,
            device) -> FusedCfgEpisode:
    """The scene's closed loop of ``n_steps`` replans as one launch of
    ``cfg_episode_quadrotor`` (K candidates, the scene's scorer at K > 1)."""
    plant, qcost = quadrotor(), quadrotor_cost()
    return make_fused_cfg_episode(
        model, make_schedule("exponential", sys_.T), *scene_stats(), plant, qcost,
        n_steps=n_steps, w=sys_.W, n_diffusion_steps_without_noise=sys_.N_TAIL, n_candidates=k,
        selection_cost=sc.select_cost if k > 1 else None, state_to_condition=sc.to_cond,
        device=device)


def chain_loop(model: Union[TemporalUnet, PackedUnet], sc: Scene, k: int, n_steps: int, device,
               chain=None):
    """``(loop, chain)``: the per-replan loop, ``make_closed_loop`` with
    the scene's ``state_to_condition`` and the CFG chain kernel at B = K
    (``chain``, or a new one) as ``sample_override``."""
    dev = resolve_device(device)
    packed = model if isinstance(model, PackedUnet) else pack_unet(model.to(dev), dev)
    schedule = make_schedule("exponential", sys_.T)
    chain = chain or make_fused_cfg_chain(packed, schedule, n_samples=k, w=sys_.W,
                                          n_tail=sys_.N_TAIL, device=dev)
    plant, qcost = quadrotor(), quadrotor_cost()
    loop = make_closed_loop(GaussianDiffusion(schedule), packed.model, *scene_stats(), plant,
                            qcost if k == 1 else sc.select_cost, horizon=HORIZON,
                            n_steps=n_steps, w=sys_.W,
                            n_diffusion_steps_without_noise=sys_.N_TAIL, n_candidates=k,
                            state_to_condition=sc.to_cond, sample_override=chain, device=dev)
    return loop, chain


def start_noise(n_starts: int, n_steps: int, k: int, device, seed: int = 31) -> torch.Tensor:
    """Each start's staged noise in turn from one generator: (n_starts,
    n_steps, T + tail + 1, K, H, 4)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.stack([torch.randn((n_steps, sys_.T + sys_.N_TAIL + 1, k, HORIZON, 4),
                                    generator=gen, device=device) for _ in range(n_starts)])


def yardstick(row: dict, k: int, protocol: bool) -> dict:
    """``row`` with ``within_yardstick`` and the gaps where the yardstick has
    K, None when the protocol differs from the yardstick's."""
    if k not in sys_.BOUNDS:
        return row
    if not protocol:
        return dict(row, within_yardstick=None)
    return dict(row, within_yardstick=sys_.within(row, k), yardstick_gaps=sys_.gaps(row, k))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--student", default=str(sys_.STUDENT))
    p.add_argument("--horizon", type=int, default=HORIZON, choices=[HORIZON])
    p.add_argument("--steps", type=int, default=sys_.N_STEPS)
    p.add_argument("--eval-starts", type=int, default=sys_.N_STARTS)
    p.add_argument("--scene-index", type=int, default=sys_.SCENE_INDEX,
                   help="which held-out scene (sample_scenes seed=99 draw) to serve; the "
                        "scene is data of the one kernel build")
    p.add_argument("--candidates", type=int, nargs="+", default=[1, 16])
    p.add_argument("--w", type=float, default=sys_.W, choices=[sys_.W])
    p.add_argument("--device", default=None, help="cuda unless given")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "bench_scene_student.json"))
    args = p.parse_args(argv)
    out_path = Path(args.out).resolve()
    if (ROOT / "artifacts") in out_path.parents:
        raise SystemExit(f"--out {args.out}: the report goes under chiprun_out/, not artifacts/")
    dev = resolve_device(args.device)
    model = load_scene_student(args.student, device=dev)
    packed = pack_unet(model, dev)
    sc = scene(args.scene_index, dev)
    n = args.eval_starts
    starts = torch.from_numpy(eval_start_states(n, seed=sys_.START_SEED)).to(dev)
    noise = start_noise(n, args.steps, max(args.candidates), dev)
    key_gen = torch.Generator(device=dev).manual_seed(3)
    protocol = (args.scene_index, n, args.steps) == (sys_.SCENE_INDEX, sys_.N_STARTS,
                                                     sys_.N_STEPS)
    out = {"scene_index": args.scene_index, "centers": sc.centers.tolist(),
           "radii": sc.radii.tolist(), "steps": args.steps, "eval_starts": n,
           "device": str(dev),
           "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for k in args.candidates:
        ep = episode(packed, sc, k, args.steps, dev)
        nz = noise[:, :, :, :k].contiguous()
        t0 = time.perf_counter()
        tracks = torch.stack([ep(starts[i], nz[i])[0] for i in range(n)])
        _sync(dev)
        out[f"k{k}_metrics_seconds"] = time.perf_counter() - t0
        out[f"k{k}"] = yardstick(track_metrics(tracks.cpu().numpy(), centers=sc.centers.cpu(),
                                               radii=sc.radii.cpu()), k, protocol)
        n_pipe = N_PIPELINED if k == 1 else max(2, N_PIPELINED // k)
        argsk = [(starts[i % n], torch.randn(ep.noise_shape, generator=key_gen, device=dev))
                 for i in range(n_pipe)]
        out[f"k{k}_hz_pipelined"] = args.steps / pipelined_time_fn(
            lambda x, z: ep(x, z)[0], argsk, n_batches=3 if k == 1 else 1)
        # sustained: a dependent chain of quality episodes (one continuous long episode)
        n_chunks, reps = (N_CHUNKS, N_REPS) if k == 1 else (max(1, N_CHUNKS // k), 1)
        chunk_noise = [torch.randn(ep.noise_shape, generator=key_gen, device=dev)
                       for _ in range(n_chunks)]

        def chained(x0):
            x = x0
            for z in chunk_noise:
                x = ep(x, z)[0][-1]
            return x

        chained(starts[0])
        _sync(dev)
        sus: List[float] = []
        for _ in range(reps):
            t0 = time.perf_counter()
            x_end = chained(starts[0])
            _sync(dev)
            sus.append(time.perf_counter() - t0)
        out[f"k{k}_hz_sustained"] = n_chunks * args.steps / min(sus)
        out[f"k{k}_sustained_protocol"] = (f"{n_chunks} chained {args.steps}-replan episodes, "
                                           f"best of {reps}")
        out[f"k{k}_sustained_finite"] = bool(torch.isfinite(x_end).all())
        loop, _ = chain_loop(packed, sc, k, args.steps, dev)
        t0 = time.perf_counter()
        xla = torch.stack([loop(starts[i], nz[i]).x_track for i in range(n)])
        _sync(dev)
        out[f"xla_k{k}_hz"] = n * args.steps / (time.perf_counter() - t0)
        out[f"xla_k{k}"] = yardstick(track_metrics(xla.cpu().numpy(), centers=sc.centers.cpu(),
                                                   radii=sc.radii.cpu()), k, protocol)
        out[f"k{k}_vs_xla_max_err"] = float((tracks[0] - xla[0]).abs().max())
        print(json.dumps({
            "metric": f"scene_student_fused_cfg_episode_k{k}_hz",
            "value": out[f"k{k}_hz_pipelined"], "unit": "Hz",
            "sustained": out[f"k{k}_hz_sustained"], **out[f"k{k}"]}), flush=True)
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
