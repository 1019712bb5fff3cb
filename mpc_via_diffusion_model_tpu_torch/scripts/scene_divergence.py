"""How far the scene-conditioned quadrotor student's protocol may part from
the JAX package's on the CPU (``data/scene_yardstick.py``), measured with the
port on the CPU before any run on the card:

    python -m mpc_via_diffusion_model_tpu_torch.scripts.scene_divergence [--seeds 3] \\
        [--k 1 16] [--threads 4] [--no-ulp] [--out PATH.json]

A 60-replan loop past three spheres is chaotic, and the port draws its noise
from torch, not from the JAX keys. So for each K (1 with the task quadratic,
16 with the scene's safety-first selection cost) and each of ``--seeds``
torch seeds, the port flies the yardstick's 16 starts through scene 0 with
the plain CFG DDPM sampler batched over the starts (``batched_closed_loop``:
``control/runtime.py``'s loop over a batch of starts, the context the state
followed by the scene's features), once as they are and, unless
``--no-ulp``, twice with their positions moved by one ulp (up and down). It
prints, per run, the ``track_metrics`` and their gaps from the yardstick's,
then ``bounds``: twice the largest gap of each metric over all runs, the
rule ``data/scene_yardstick.py``'s ``BOUNDS`` follow. About 3 minutes per
K = 16 run at 4 threads, a few seconds per K = 1 run.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np
import torch

from ..control.conditions import ConcatFeatures
from ..control.runtime import make_closed_loop
from ..core.schedules import make_schedule
from ..data import scene_yardstick as sys_
from ..data.scene_stats import scene_stats
from ..diffusion.gaussian_diffusion import GaussianDiffusion
from ..dynamics.quadrotor import quadrotor, quadrotor_cost
from ..models.weights import load_scene_student
from .quadrotor_task import make_select_cost, sample_scenes, scene_features, track_metrics

__all__ = ["METRICS", "scene", "batched_closed_loop", "run", "gaps", "main"]

METRICS = ("collision_free_fraction", "min_clearance_mean", "goal_dist_mean",
           "goal_reach_fraction_0.5", "safe_reach_fraction")


def scene(index: int = sys_.SCENE_INDEX, seed: int = sys_.SCENE_SEED):
    """(centers (3, 3), radii (3,)) of held-out scene ``index`` of the
    ``sample_scenes(index + 1, seed)`` draw, float32 numpy."""
    c, r = sample_scenes(index + 1, seed=seed)
    return c[index], r[index]


def batched_closed_loop(model, starts: torch.Tensor, noise: torch.Tensor, n_candidates: int,
                        centers, radii) -> torch.Tensor:
    """The scene student's closed loop from every start at once, the batched
    ``make_closed_loop`` on the CPU: ``noise`` (B, n_steps, n_total + 1, K,
    48, 4) is each replan's CFG DDPM draw; the context is the state followed
    by the scene's features; at K > 1 candidates are scored by the scene's
    safety-first selection cost over their whole rollout (terminal cost
    included) and the first minimum wins. Returns the tracks (B, n_steps +
    1, 12)."""
    loop = make_closed_loop(GaussianDiffusion(make_schedule("exponential", sys_.T)), model,
                            *scene_stats(), quadrotor(),
                            make_select_cost(quadrotor_cost(), centers=centers, radii=radii),
                            horizon=48, n_steps=noise.shape[1], w=sys_.W,
                            n_diffusion_steps_without_noise=sys_.N_TAIL,
                            n_candidates=n_candidates,
                            state_to_condition=ConcatFeatures(scene_features(centers, radii)),
                            device="cpu")
    return loop(starts, noise).x_track


def _ulp(starts: np.ndarray, direction: float) -> np.ndarray:
    """The starts with their positions moved by one ulp toward ``direction``."""
    out = starts.copy()
    out[:, :3] = np.nextafter(out[:, :3], np.float32(direction))
    return out


def run(model, k: int, seed: int, starts: np.ndarray, centers, radii,
        n_steps: int = sys_.N_STEPS) -> np.ndarray:
    """The tracks of one run: torch-seeded noise (``seed``), the given starts."""
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn((len(starts), n_steps, sys_.T + sys_.N_TAIL + 1, k, 48, 4), generator=g)
    return batched_closed_loop(model, torch.from_numpy(starts), noise, k, centers, radii).numpy()


def gaps(metrics: Dict[str, float], want: Dict[str, float]) -> Dict[str, float]:
    return {m: abs(metrics[m] - want[m]) for m in METRICS}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--k", type=int, nargs="+", default=[1, 16])
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--no-ulp", action="store_true", help="only the starts as they are")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    model = load_scene_student(sys_.STUDENT, device="cpu")
    starts = sys_.eval_starts()
    cen, rad = scene()
    out: Dict[str, List[dict]] = {}
    worst = {m: 0.0 for m in METRICS}
    variants = [("as is", starts)]
    if not args.no_ulp:
        variants += [("+1 ulp", _ulp(starts, np.inf)), ("-1 ulp", _ulp(starts, -np.inf))]
    for k in args.k:
        want = sys_.METRICS[k]
        rows = []
        for seed in range(args.seeds):
            for label, x0 in variants:
                met = track_metrics(run(model, k, seed, x0, cen, rad), centers=cen, radii=rad)
                row = {"k": k, "seed": seed, "starts": label, "metrics": met,
                       "gaps": gaps(met, want)}
                for m in METRICS:
                    worst[m] = max(worst[m], row["gaps"][m])
                rows.append(row)
                print(json.dumps(row), flush=True)
        out[f"k{k}"] = rows
    result = {"runs": out, "worst_gaps": worst, "bounds": {m: 2 * v for m, v in worst.items()}}
    print(json.dumps({"worst_gaps": worst, "bounds": result["bounds"]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
