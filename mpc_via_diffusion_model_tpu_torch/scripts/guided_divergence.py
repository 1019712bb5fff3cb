"""How far the guided quadrotor rows may part from the JAX package's on the
CPU (``data/guided_yardstick.py``), measured with the port on the CPU before
any run on the card:

    python -m mpc_via_diffusion_model_tpu_torch.scripts.guided_divergence \\
        [--rows guided unguided oracle blind] [--seeds 3] [--ulp-seeds 1] \\
        [--threads 2] [--steps 60] [--out PATH.json]
    python -m ...guided_divergence --merge A.json B.json ...   # the paired gates' bounds
    python -m ...guided_divergence --first-plans --seeds 16     # the held-out first plans

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

Each run also records every start's min clearance after each replan
(``running_clearance``), from which ``paired_bounds`` (``--merge`` over the
``--out`` files of runs made apart, one process per row) pairs each row with
its unguided twin of the same seed and starts (``gys.PAIRS``) into the
paired gates' bounds. ``--first-plans`` runs only the held-out protocol's
128 pairs' first replan, the oracle against the blind teacher on the same
noise, per seed (~1 minute each), and prints the ``heldout_first_plans``
gate's bounds.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import guided_yardstick as gys
from ..dynamics.base import rollout
from ..dynamics.quadrotor import quadrotor
from .flagship_quadrotor import flagship_loop, teacher
from . import quadrotor_task
from .quadrotor_task import eval_start_states, sample_scenes, track_metrics
from .scene_conditioned_quadrotor import Pairs, teacher_loop

__all__ = ["starts", "scene0", "running_clearance", "plan_clearance", "first_plans", "run",
           "paired_bounds", "first_plans_bounds", "main"]


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


def running_clearance(x_track: np.ndarray, row: str) -> np.ndarray:
    """(N, n_steps + 1): each start's min clearance from its row's scene over
    its track's first t + 1 states (the canonical scene in the flagship's
    rows, scene 0 in the study's)."""
    c, r = (None, None) if row in ("guided", "unguided") else scene0()
    c = quadrotor_task.OBS_CENTERS if c is None else c
    r = quadrotor_task.OBS_RADII if r is None else r
    d = np.linalg.norm(x_track[..., :, None, 0:3] - c, axis=-1) - r
    return np.minimum.accumulate(d.min(axis=-1), axis=1)


def plan_clearance(x0: torch.Tensor, u_plan: torch.Tensor, centers: torch.Tensor,
                   radii: torch.Tensor) -> np.ndarray:
    """(N,): each start's plan (controls (N, H, 4)) rolled open-loop from the
    start (N, 12), its min clearance from its scene (centers (N, 3, 3), radii
    (N, 3))."""
    states = rollout(quadrotor(), x0, u_plan)
    return quadrotor_task.min_clearance_torch(states, centers.to(states.device),
                                              radii.to(states.device)).cpu().numpy()


def first_plans(packed, seed: int, x0: Optional[np.ndarray] = None) -> Dict[str, list]:
    """The held-out pairs' (``Pairs(N_SCENES, N_STARTS)``) first plans'
    open-loop clearance from their own scenes, for the per-scene guided
    oracle and the scene-blind teacher on the same torch-seeded noise (one
    replan each, batched over the 128 pairs), as lists by row; ``x0``
    replaces the pairs' starts."""
    prs = Pairs(gys.N_SCENES, gys.N_STARTS, "cpu")
    starts = prs.x0 if x0 is None else torch.from_numpy(x0)
    noise = torch.randn((len(prs), 1, gys.T + gys.N_TAIL + 1, 1, 48, 4),
                        generator=torch.Generator().manual_seed(seed))
    out = {}
    for row in ("oracle", "blind"):
        loop, _ = teacher_loop(packed, prs.centers, prs.radii, 1, "cpu", guided=row == "oracle")
        res = loop(starts, noise)
        out[row] = plan_clearance(res.x_track[:, 0], res.u_horizons[:, 0], prs.centers,
                                  prs.radii).tolist()
    return out


def run(packed, row: str, seed: int, x0: np.ndarray, n_steps: int = gys.N_STEPS) -> dict:
    """``track_metrics`` of one CPU run of ``row`` from ``x0`` with the
    torch-seeded noise ``seed`` (stage costs in the flagship's rows), under
    ``running_clearance`` each start's min clearance after every replan
    (:func:`running_clearance`), as lists."""
    n = len(x0)
    noise = torch.randn((n, n_steps, gys.T + gys.N_TAIL + 1, 1, 48, 4),
                        generator=torch.Generator().manual_seed(seed))
    if row in ("guided", "unguided"):
        loop, _ = flagship_loop(packed, row == "guided", n, n_steps, "cpu")
        res = loop(torch.from_numpy(x0), noise)
        met = track_metrics(res.x_track.numpy(), res.stage_costs.numpy())
    else:
        c, r = scene0()
        cen = torch.from_numpy(np.repeat(c[None], n, axis=0))
        rad = torch.from_numpy(np.repeat(r[None], n, axis=0))
        loop, _ = teacher_loop(packed, cen, rad, n_steps, "cpu", guided=row == "oracle")
        res = loop(torch.from_numpy(x0), noise)
        met = track_metrics(res.x_track.numpy(), centers=c, radii=r)
    return dict(met, running_clearance=running_clearance(res.x_track.numpy(), row).T.tolist())


def paired_bounds(runs: Dict[str, List[dict]]) -> dict:
    """The paired gates' spread (``data/guided_yardstick.py``'s ``paired``)
    over ``runs`` (row -> records of :func:`main`, from one process or
    several): for each pair of rows (``gys.PAIRS``), every (seed, starts)
    run of both rows paired at the last replan, the largest gap of each
    statistic from the JAX package's (``gys.PAIRED``), and the bound, twice
    that gap, the count's at least 2."""
    out = {}
    for pair, (a, b) in gys.PAIRS.items():
        by_key = {(r["seed"], r["starts"]): r for r in runs.get(b, [])}
        matched = [(r, by_key[(r["seed"], r["starts"])]) for r in runs.get(a, [])
                   if (r["seed"], r["starts"]) in by_key]
        if not matched:
            continue
        last = lambda rec: np.asarray(rec["metrics"]["running_clearance"])[-1]
        stats = [gys.paired(last(ra), last(rb)) for ra, rb in matched]
        want = gys.PAIRED[pair]
        worst = {m: max(abs(st[m] - want[m]) for st in stats) for m in want}
        out[pair] = {"runs": len(matched), "reference": want, "stats": stats,
                     "worst_gaps": worst,
                     "bounds": {m: max(2 * g, 2.0) if m == "n_raised" else 2 * g
                                for m, g in worst.items()}}
    return out


def first_plans_bounds(recs: List[dict]) -> dict:
    """The first-plans gate's largest gaps from the JAX package's
    (``gys.PAIRED["heldout_first_plans"]``) over :func:`first_plans`' records,
    and the bounds: twice those, the count's at least 2."""
    want = gys.PAIRED.get("heldout_first_plans")
    if not want:
        return {}
    worst = {m: max(abs(r["paired"][m] - want[m]) for r in recs) for m in want}
    return {"worst_gaps": worst,
            "bounds": {m: max(2 * g, 2.0) if m == "n_raised" else 2 * g for m, g in worst.items()}}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", nargs="+", default=list(gys.ROWS), choices=list(gys.ROWS))
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--ulp-seeds", type=int, default=1)
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--steps", type=int, default=gys.N_STEPS)
    p.add_argument("--out", default=None)
    p.add_argument("--merge", nargs="+", default=None,
                   help="no runs: the paired gates' bounds over these --out files' runs")
    p.add_argument("--first-plans", action="store_true",
                   help="only the held-out pairs' first plans (oracle and blind) per seed")
    args = p.parse_args(argv)
    if args.first_plans:
        torch.set_num_threads(args.threads)
        packed = teacher("cpu")
        recs = []
        for seed in range(args.seeds):
            variants = [("as is", None)]
            if seed < args.ulp_seeds:
                x0 = Pairs(gys.N_SCENES, gys.N_STARTS, "cpu").x0.numpy()
                variants += [("+1 ulp", _ulp(x0, np.inf)), ("-1 ulp", _ulp(x0, -np.inf))]
            for label, x0 in variants:
                clear = first_plans(packed, seed, x0)
                recs.append({"seed": seed, "starts": label, "clearance": clear,
                             "paired": gys.paired(clear["oracle"], clear["blind"])})
                print(json.dumps({k: v for k, v in recs[-1].items() if k != "clearance"}),
                      flush=True)
        result = {"first_plans": recs, **first_plans_bounds(recs)}
        print(json.dumps({k: v for k, v in result.items() if k != "first_plans"}), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        return result
    if args.merge:
        runs: Dict[str, List[dict]] = {}
        for path in args.merge:
            with open(path) as f:
                for row, recs in json.load(f)["runs"].items():
                    runs.setdefault(row, []).extend(recs)
        result = paired_bounds(runs)
        print(json.dumps(result, indent=1), flush=True)
        return result
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
                print(json.dumps({**rec, "metrics": {m: v for m, v in met.items()
                                                     if m != "running_clearance"}}), flush=True)
    bounds = {row: {m: max(2 * g, 2 / gys.N_STARTS) if m.endswith("fraction") else 2 * g
                    for m, g in w.items()} for row, w in worst.items()}
    result = {"runs": out, "worst_gaps": worst, "bounds": bounds,
              "paired": paired_bounds(out) if args.steps == gys.N_STEPS else {}}
    print(json.dumps({"worst_gaps": worst, "bounds": bounds}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
