"""How far the quadrotor student's 64-start protocol may part from the JAX
package's on the CPU (``data/quadrotor_yardstick.py``), measured with the
port on the CPU before any run on the card:

    python -m mpc_via_diffusion_model_tpu_torch.scripts.quadrotor_divergence [--seeds 3] \\
        [--k 1 16] [--threads 4] [--out PATH.json]

A 60-replan loop past three obstacles is chaotic: a plan that grazes a
sphere in one run may clear it in another that differs by an ulp, and the
port draws its noise from torch, not from the JAX key. So for each K (1, and
16 with the safety-first selection cost) and each of ``--seeds`` torch
seeds, the port runs the 64 eval starts once as they are and twice with their
positions moved by one ulp (up and down), with the plain student sampler
batched over the starts (``batched_closed_loop``, the per-replan loop of
``control/runtime.py`` over a batch of starts). It prints, per run, the
``track_metrics`` and their gaps from the yardstick's, and, per perturbed run,
how many starts flip collision-free or goal reach against the unperturbed
run of the same seed; then ``bounds``, twice the largest gap of each metric
over all runs, the rule ``data/quadrotor_yardstick.py``'s ``BOUNDS`` follow.
About 6 minutes at 4 threads.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np
import torch

from ..core.schedules import make_schedule
from ..data import quadrotor_yardstick as qys
from ..data.normalization import normalize, unnormalize
from ..data.quadrotor_stats import quadrotor_stats
from ..diffusion.distillation import make_student_ddim_sampler
from ..dynamics.quadrotor import quadrotor, quadrotor_cost
from ..models.weights import load_quadrotor_student
from .quadrotor_task import eval_start_states, make_select_cost, min_clearance, track_metrics

__all__ = ["batched_closed_loop", "run", "flags", "gaps", "main"]

METRICS = ("collision_free_fraction", "min_clearance_mean", "goal_dist_mean",
           "goal_reach_fraction_0.5", "safe_reach_fraction")


@torch.no_grad()
def batched_closed_loop(model, starts: torch.Tensor, noise: torch.Tensor, n_candidates: int):
    """The student's closed loop from every start at once: ``noise`` (B,
    n_steps, K, 48, 4) is each replan's initial draw; at K > 1 candidates are
    scored by the safety-first selection cost over their whole rollout
    (terminal cost included) and the first minimum wins. Returns the tracks
    (B, n_steps + 1, 12)."""
    ins, cond = quadrotor_stats()
    plant, qcost = quadrotor(), quadrotor_cost()
    sel = make_select_cost(qcost)
    sample = make_student_ddim_sampler(make_schedule("exponential", qys.T), model, qys.TIMES)
    b, n_steps, k, horizon, du = noise.shape
    x, xs = starts, [starts]
    for i in range(n_steps):
        ctx = normalize(cond, x)[:, None].expand(b, k, x.shape[-1]).reshape(b * k, -1)
        u = unnormalize(ins, sample(ctx, noise[:, i].reshape(b * k, horizon, du)))
        u = u.reshape(b, k, horizon, du)
        if k == 1:
            u0 = u[:, 0, 0]
        else:
            xc = x[:, None].expand(b, k, x.shape[-1])
            acc = torch.zeros((b, k))
            for t in range(horizon):
                acc = acc + sel.stage(xc, u[:, :, t])
                xc = plant.step(xc, u[:, :, t])
            acc = acc + sel.terminal(xc)
            u0 = u[torch.arange(b), torch.argmin(acc, dim=1), 0]
        x = plant.step(x, u0)
        xs.append(x)
    return torch.stack(xs, dim=1)


def _ulp(starts: np.ndarray, direction: float) -> np.ndarray:
    """The starts with their positions moved by one ulp toward ``direction``."""
    out = starts.copy()
    out[:, :3] = np.nextafter(out[:, :3], np.float32(direction))
    return out


def run(model, k: int, seed: int, starts: np.ndarray, n_steps: int = qys.N_STEPS) -> np.ndarray:
    """The tracks of one run: torch-seeded noise (``seed``), the given starts."""
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn((len(starts), n_steps, k, 48, 4), generator=g)
    return batched_closed_loop(model, torch.from_numpy(starts), noise, k).numpy()


def flags(xt: np.ndarray) -> Dict[str, np.ndarray]:
    """Per start: collision-free and goal reach (the fractions' summands)."""
    return {"collision_free": min_clearance(xt) > 0,
            "goal_reach": np.linalg.norm(xt[:, -1, 0:3], axis=-1) < 0.5}


def gaps(metrics: Dict[str, float], want: Dict[str, float]) -> Dict[str, float]:
    return {m: abs(metrics[m] - want[m]) for m in METRICS}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--k", type=int, nargs="+", default=[1, 16])
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    model = load_quadrotor_student(qys.STUDENT, device="cpu")
    starts = eval_start_states(qys.N_STARTS)
    out: Dict[str, List[dict]] = {}
    worst = {m: 0.0 for m in METRICS}
    for k in args.k:
        want = qys.METRICS[k]
        rows = []
        for seed in range(args.seeds):
            base = None
            for label, x0 in (("as is", starts), ("+1 ulp", _ulp(starts, np.inf)),
                              ("-1 ulp", _ulp(starts, -np.inf))):
                xt = run(model, k, seed, x0)
                met = track_metrics(xt)
                row = {"k": k, "seed": seed, "starts": label, "metrics": met,
                       "gaps": gaps(met, want)}
                cf = flags(xt)
                if base is None:
                    base = cf
                else:
                    row["flips"] = {name: int((cf[name] != base[name]).sum()) for name in cf}
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
