"""How far the guided quadrotor rows may part from the JAX package's on the
CPU (``data/guided_yardstick.py``), measured with the port on the CPU before
any run on the card:

    python -m mpc_via_diffusion_model_tpu_torch.scripts.guided_divergence \\
        [--rows guided unguided oracle blind] [--seeds 3] [--ulp-seeds 1] \\
        [--threads 2] [--steps 60] [--out PATH.json]

A 60-replan loop past three spheres is chaotic, and the port draws its noise
from torch, not from the JAX keys. So for each row of the yardstick (the
flagship's ``guided`` and ``unguided``, the scene study's scene-0 ``oracle``
and ``blind``) and each of ``--seeds`` torch seeds, the port flies the
yardstick's 16 starts as one batched loop on the CPU, through the same loop
builders as the card's scripts (``flagship_quadrotor.flagship_loop``,
``scene_conditioned_quadrotor.teacher_loop``: the plain U-Net and chain
there), with the starts as they are and, for the first ``--ulp-seeds``
seeds, with their positions moved by one ulp (up and down). It prints, per
run, the ``track_metrics`` and their gaps from the yardstick's, then
``bounds``: twice the largest gap of each metric over all runs, and for a
fraction at least 2 of the 16 starts, the rule of ``BOUNDS``. A guided run
takes a few minutes at 2 threads, an unguided one about one.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np
import torch

from ..data import guided_yardstick as gys
from .flagship_quadrotor import flagship_loop, teacher
from .quadrotor_task import eval_start_states, sample_scenes, track_metrics
from .scene_conditioned_quadrotor import teacher_loop

__all__ = ["starts", "scene0", "run", "main"]


def starts(row: str) -> np.ndarray:
    """The row's 16 starts, (16, 12) float32."""
    seed = gys.FLAGSHIP_START_SEED if row in ("guided", "unguided") else gys.SCENE_START_SEED
    return eval_start_states(gys.N_STARTS, seed=seed)


def scene0():
    """(centers (3, 3), radii (3,)) of the study's scene 0, of the
    ``sample_scenes(N_SCENES, seed=SCENE_SEED)`` draw."""
    c, r = sample_scenes(gys.N_SCENES, seed=gys.SCENE_SEED)
    return c[0], r[0]


def _ulp(x0: np.ndarray, direction: float) -> np.ndarray:
    out = x0.copy()
    out[:, :3] = np.nextafter(out[:, :3], np.float32(direction))
    return out


def run(packed, row: str, seed: int, x0: np.ndarray, n_steps: int = gys.N_STEPS) -> dict:
    """``track_metrics`` of one CPU run of ``row`` from ``x0`` with the
    torch-seeded noise ``seed`` (stage costs in the flagship's rows)."""
    n = len(x0)
    noise = torch.randn((n, n_steps, gys.T + gys.N_TAIL + 1, 1, 48, 4),
                        generator=torch.Generator().manual_seed(seed))
    if row in ("guided", "unguided"):
        loop, _ = flagship_loop(packed, row == "guided", n, n_steps, "cpu")
        res = loop(torch.from_numpy(x0), noise)
        return track_metrics(res.x_track.numpy(), res.stage_costs.numpy())
    c, r = scene0()
    cen = torch.from_numpy(np.repeat(c[None], n, axis=0))
    rad = torch.from_numpy(np.repeat(r[None], n, axis=0))
    loop, _ = teacher_loop(packed, cen, rad, n_steps, "cpu", guided=row == "oracle")
    return track_metrics(loop(torch.from_numpy(x0), noise).x_track.numpy(), centers=c, radii=r)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", nargs="+", default=list(gys.ROWS), choices=list(gys.ROWS))
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--ulp-seeds", type=int, default=1)
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--steps", type=int, default=gys.N_STEPS)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    packed = teacher("cpu")
    out: Dict[str, List[dict]] = {}
    worst: Dict[str, Dict[str, float]] = {}
    for row in args.rows:
        want = gys.METRICS[row]
        worst[row] = {m: 0.0 for m in want}
        out[row] = []
        for seed in range(args.seeds):
            variants = [("as is", starts(row))]
            if seed < args.ulp_seeds:
                variants += [("+1 ulp", _ulp(starts(row), np.inf)),
                             ("-1 ulp", _ulp(starts(row), -np.inf))]
            for label, x0 in variants:
                met = run(packed, row, seed, x0, args.steps)
                gaps = {m: abs(met[m] - want[m]) for m in want}
                for m in want:
                    worst[row][m] = max(worst[row][m], gaps[m])
                rec = {"row": row, "seed": seed, "starts": label, "metrics": met, "gaps": gaps}
                out[row].append(rec)
                print(json.dumps(rec), flush=True)
    bounds = {row: {m: max(2 * g, 2 / gys.N_STARTS) if m.endswith("fraction") else 2 * g
                    for m, g in w.items()} for row, w in worst.items()}
    result = {"runs": out, "worst_gaps": worst, "bounds": bounds}
    print(json.dumps({"worst_gaps": worst, "bounds": bounds}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
