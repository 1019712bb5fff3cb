"""How far the panda student's rows may part from the JAX package's on the
CPU (``data/panda_yardstick.py``), measured with the port on the CPU before
any run on the card:

    python -m mpc_via_diffusion_model_tpu_torch.scripts.panda_divergence [--seeds 8] \\
        [--first-seed 0] [--rows k1 k16_selh32 episode episode_k4_selh16] [--threads 2] \\
        [--out PATH.json]

The port draws its noise from torch, not from the JAX keys, so a row's
costs on the card are another sample of the same episodes. For each row
and each of ``--seeds`` torch seeds, the port runs the row's 10 episodes
(x0 = 0.3 rad on every joint, 80 replans) as one batched loop
(``batched_stage_costs``: ``control/runtime.py``'s loop over a batch of
starts, the plain student sampler, the row's plant: ``panda_rbd`` for the
chain split, ``panda_rbd_unrolled``, the episode kernel's plain plant, for
the episode rows), once from x0 as it is and once from x0 moved by one ulp
up and once down. It prints, per run, the episodes' costs, their mean and,
for a row the card cuts short (``PREFIX_STEPS``), the mean of their
prefixes, each with its gap from the yardstick; then ``bounds``, twice the
largest gap over all runs, the rule ``data/panda_yardstick.py``'s
``BOUNDS`` follow. About 2 minutes per run of a K = 1 row at 2 threads,
3 per K = 16 run; the rows run in processes of their own.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np
import torch

from ..control import make_closed_loop
from ..core.schedules import make_schedule
from ..data import panda_yardstick as pys
from ..data.panda_stats import panda_stats
from ..diffusion import GaussianDiffusion, make_student_ddim_sampler
from ..dynamics.arm import make_panda_context, panda_cost, panda_rbd, panda_rbd_unrolled
from ..models.weights import load_panda_student

__all__ = ["batched_stage_costs", "row_plant", "main"]


def row_plant(row: str):
    """The plant a row's loop steps: the chain split's ``panda_rbd``, or the
    episode kernel's plain plant ``panda_rbd_unrolled``."""
    return panda_rbd_unrolled() if row.startswith("episode") else panda_rbd()


@torch.no_grad()
def batched_stage_costs(model, plant, k: int, sel_h, starts: torch.Tensor,
                        noise: torch.Tensor) -> torch.Tensor:
    """Each start's stage costs (N, n_steps) through the loop of a row:
    ``make_closed_loop`` over the batch of starts (N, 14) with the student's
    DDIM sampler, ``noise`` (N, n_steps, K, 128, 7) each replan's initial
    draw, ``plant``, K candidates scored over ``sel_h`` steps."""
    schedule = make_schedule("exponential", pys.T)
    loop = make_closed_loop(GaussianDiffusion(schedule), model, *panda_stats(), plant,
                            panda_cost(), horizon=pys.H, n_steps=noise.shape[1], n_candidates=k,
                            state_to_condition=make_panda_context(),
                            sample_override=make_student_ddim_sampler(schedule, model, pys.TIMES),
                            selection_horizon=sel_h, noise_shape=(k, pys.H, 7),
                            device=starts.device)
    return loop(starts, noise).stage_costs


def _x0(direction: float = 0.0) -> np.ndarray:
    """x0, its joint angles moved by one ulp toward ``direction`` unless 0."""
    x0 = pys.x0()
    if direction:
        x0[:7] = np.nextafter(x0[:7], np.float32(direction))
    return x0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=0,
                   help="run torch seeds first-seed .. first-seed + seeds - 1 (to split a row "
                        "over processes; the bounds are then the largest gap over their runs)")
    p.add_argument("--rows", nargs="+", default=list(pys.ROWS))
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    model = load_panda_student(pys.STUDENT, device="cpu")
    out: Dict[str, List[dict]] = {}
    worst: Dict[str, Dict[str, float]] = {}
    for row in args.rows:
        k, sel_h = pys.ROWS[row]
        n_pre = pys.PREFIX_STEPS.get(row)
        runs, worst[row] = [], {}
        for seed in range(args.first_seed, args.first_seed + args.seeds):
            g = torch.Generator().manual_seed(seed)
            noise = torch.randn((pys.N_SEEDS, pys.N_STEPS, k, pys.H, 7), generator=g)
            for label, direction in (("as is", 0.0), ("+1 ulp", np.inf), ("-1 ulp", -np.inf)):
                starts = torch.from_numpy(_x0(direction)).expand(pys.N_SEEDS, 14).contiguous()
                stages = batched_stage_costs(model, row_plant(row), k, sel_h, starts,
                                             noise).double()
                costs = stages.sum(-1).numpy()
                prefix = stages[:, :n_pre].sum(-1).numpy() if n_pre else None
                gap = pys.gaps(row, costs, prefix)
                for key, v in gap.items():
                    worst[row][key] = max(worst[row].get(key, 0.0), v)
                run = {"row": row, "seed": seed, "x0": label, "costs": costs.tolist(),
                       "mean10": float(costs.mean()), "gaps": gap}
                if n_pre:
                    run["prefix_mean10"] = float(prefix.mean())
                runs.append(run)
                print(json.dumps(run), flush=True)
        out[row] = runs
    result = {"runs": out, "worst_gaps": worst,
              "bounds": {r: {key: 2 * v for key, v in g.items()} for r, g in worst.items()}}
    print(json.dumps({"worst_gaps": worst, "bounds": result["bounds"]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
