"""How far the panda teacher's rows may part from the JAX package's on the
CPU (``data/panda_teacher_yardstick.py``), measured with the port on the
CPU before its kernels ran on the card:

    python -m mpc_via_diffusion_model_tpu_torch.scripts.panda_teacher_divergence \\
        [--rows chain episode] [--seeds 5] [--first-seed 0] [--draws torch philox] \\
        [--threads 4] [--out PATH.json] [--paired]

The port draws its noise from torch, or in the kernel by Philox, not from
the JAX keys, so a row's costs on the card are another sample of the same
episodes. For each row and seed, the port runs the row's 10 episodes (x0 =
0.3 rad on every joint, 80 replans, K = 1) as one batched loop
(``batched_stage_costs``: ``control/runtime.py``'s loop over a batch of
starts with the plain CFG DDPM chain, the row's plant: ``panda_rbd`` for
the chain, ``panda_rbd_unrolled``, the episode kernel's plain plant, for the
episode), on staged noise of two kinds (``--draws``): ``torch``, drawn from
``torch.Generator().manual_seed(seed)``, and ``philox``, episode i's draw of
the seed ``seed_from_generator(torch.Generator().manual_seed(1000 seed +
i))`` staged by ``cfg_normal_table``, the in-kernel draw's table. It prints,
per run, the episodes' costs, their mean and the mean of their first
``PREFIX_STEPS`` replans, each with its gap from the yardstick; then
``bounds``, twice the largest gap over all runs, the rule the yardstick's
``BOUNDS`` follow. About 2 minutes per run at 4 threads.

``--paired`` instead computes the yardstick's paired gate (``PAIRED_*``):
the plain episode (``panda_rbd_unrolled``) of each of chip_smoke.py's 10
draw seeds (``seed_from_generator(torch.Generator().manual_seed(
PAIRED_SEED_BASE + i))``) on its ``cfg_normal_table``, over the first
``PREFIX_STEPS`` replans, as one batched loop, and the same with fp32-sized
differences put in (``PERTURBATIONS``: every eps moved by a relative 1e-6
under two fixed sign patterns, every plant step's next state moved by a
relative 1e-6, x0 moved by one ulp), and with two controls that a paired
gate must fail (``CONTROLS``: w = 0, and the draw counter one replan on).
It prints each run's costs and gaps from the first, and the bound, twice
the largest gap over the perturbed runs. About 20 s per run at 4 threads.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, Dict, List

import torch

from ..control import make_closed_loop
from ..core.schedules import make_schedule
from ..data import panda_teacher_yardstick as tys
from ..data.panda_stats import panda_stats
from ..diffusion import GaussianDiffusion
from ..dynamics.arm import make_panda_context, panda_cost, panda_rbd, panda_rbd_unrolled
from ..models.weights import load_panda_teacher
from ..ops import philox

__all__ = ["batched_stage_costs", "row_plant", "staged_draws", "paired_tables", "paired_run",
           "PERTURBATIONS", "CONTROLS", "paired", "main"]


def row_plant(row: str):
    """The plant a row's loop steps: the chain's ``panda_rbd``, or the episode
    kernel's plain plant ``panda_rbd_unrolled``."""
    return panda_rbd_unrolled() if row == "episode" else panda_rbd()


@torch.no_grad()
def batched_stage_costs(model, plant, starts: torch.Tensor, noise: torch.Tensor,
                        w: float = tys.W) -> torch.Tensor:
    """Each start's stage costs (N, n_steps) through the teacher's plain CFG
    loop: ``make_closed_loop`` over the batch of starts (N, 14), T = 25 + 5,
    w (0.01 unless given), K = 1, ``noise`` (N, n_steps, n_total + 1, 1, 128,
    7) each replan's staged draws, ``plant``."""
    loop = make_closed_loop(GaussianDiffusion(make_schedule("exponential", tys.T)), model,
                            *panda_stats(), plant, panda_cost(), horizon=tys.H,
                            n_steps=noise.shape[1], w=w,
                            n_diffusion_steps_without_noise=tys.N_TAIL,
                            state_to_condition=make_panda_context(), device=starts.device)
    return loop(starts, noise).stage_costs


def staged_draws(kind: str, seed: int, n_steps: int = tys.N_STEPS) -> torch.Tensor:
    """(N_SEEDS, n_steps, T + N_TAIL + 1, 1, 128, 7): the 10 episodes' staged
    draws of ``kind`` (``torch`` or ``philox``) and ``seed``."""
    shape = (n_steps, tys.T + tys.N_TAIL + 1, 1, tys.H, 7)
    if kind == "torch":
        return torch.randn((tys.N_SEEDS, *shape), generator=torch.Generator().manual_seed(seed))
    seeds = [philox.seed_from_generator(torch.Generator().manual_seed(1000 * seed + i))
             for i in range(tys.N_SEEDS)]
    return torch.stack([philox.cfg_normal_table(s, n_steps, tys.T + tys.N_TAIL, 1, tys.H, 7)
                        for s in seeds])


def paired_tables(n_steps: int = tys.PREFIX_STEPS, shift: int = 0) -> torch.Tensor:
    """(N_SEEDS, n_steps, T + N_TAIL + 1, 1, 128, 7): the draws of the paired
    gate's 10 seeds, ``cfg_normal_table`` from replan ``shift`` on."""
    seeds = [philox.seed_from_generator(torch.Generator().manual_seed(tys.PAIRED_SEED_BASE + i))
             for i in range(tys.N_SEEDS)]
    return torch.stack([philox.cfg_normal_table(s, n_steps + shift, tys.T + tys.N_TAIL, 1,
                                                tys.H, 7)[shift:] for s in seeds])


def _signs(shape, seed: int) -> torch.Tensor:
    return torch.sign(torch.rand(shape, generator=torch.Generator().manual_seed(seed)) - 0.5)


def _eps_moved(model, seed: int):
    """``model`` with every output moved by a relative 1e-6 (a fixed sign pattern per shape)."""
    cache = {}

    def moved(x, t, c, m):
        y = model(x, t, c, m)
        if y.shape not in cache:
            cache[y.shape] = _signs(y.shape, seed)
        return y * (1 + 1e-6 * cache[y.shape])
    return moved


def _step_moved(plant):
    """``plant`` whose every next state is moved by a relative 1e-6 (a fixed sign pattern)."""
    signs = _signs((tys.N_SEEDS, 14), 3)
    return dataclasses.replace(plant, step=lambda x, u: plant.step(x, u) * (1 + 1e-6 * signs))


def paired_run(model, eps_seed=None, step_moved=False, x0_ulp=False, w=tys.W,
               shift=0) -> List[float]:
    """The 10 paired episodes' costs of their first PREFIX_STEPS replans (float64 sums of the
    float32 stage costs) through the plain episode's loop, with the changes named."""
    starts = torch.from_numpy(tys.x0()).expand(tys.N_SEEDS, 14).contiguous()
    if x0_ulp:
        starts = torch.nextafter(starts, torch.ones_like(starts))
    plant = row_plant("episode")
    den = model if eps_seed is None else _eps_moved(model, eps_seed)
    stages = batched_stage_costs(den, _step_moved(plant) if step_moved else plant, starts,
                                 paired_tables(shift=shift), w=w).double()
    return stages.sum(-1).tolist()


# the fp32-sized differences the paired bound is set from, and the controls it must fail
PERTURBATIONS: Dict[str, Callable] = {
    "eps_1e-6_a": lambda m: paired_run(m, eps_seed=1),
    "eps_1e-6_b": lambda m: paired_run(m, eps_seed=2),
    "step_1e-6": lambda m: paired_run(m, step_moved=True),
    "x0_ulp": lambda m: paired_run(m, x0_ulp=True),
}
CONTROLS: Dict[str, Callable] = {
    "w0": lambda m: paired_run(m, w=0.0),
    "counter_shift1": lambda m: paired_run(m, shift=1),
}


def paired(model) -> dict:
    """The paired gate's literals: the base run's costs, each other run's
    per-episode gaps from them, and the bound (twice the largest gap over
    ``PERTURBATIONS``)."""
    base = paired_run(model)
    print(json.dumps({"run": "base", "prefix": base}), flush=True)
    runs = {}
    for name, fn in {**PERTURBATIONS, **CONTROLS}.items():
        costs = fn(model)
        runs[name] = {"prefix": costs, "gaps": [abs(a - b) for a, b in zip(costs, base)]}
        print(json.dumps({"run": name, **runs[name]}), flush=True)
    bound = 2 * max(max(runs[name]["gaps"]) for name in PERTURBATIONS)
    out = {"base": base, "runs": runs, "bound": bound,
           "controls_fail": {name: max(runs[name]["gaps"]) > bound for name in CONTROLS}}
    print(json.dumps({"bound": bound, "controls_fail": out["controls_fail"]}), flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", nargs="+", default=list(tys.ROWS))
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--first-seed", type=int, default=0)
    p.add_argument("--draws", nargs="+", default=["torch", "philox"])
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--out", default=None)
    p.add_argument("--paired", action="store_true")
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    model = load_panda_teacher(tys.TEACHER, device="cpu")
    if args.paired:
        result = paired(model)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        return result
    starts = torch.from_numpy(tys.x0()).expand(tys.N_SEEDS, 14).contiguous()
    runs: Dict[str, List[dict]] = {}
    worst: Dict[str, Dict[str, float]] = {}
    for row in args.rows:
        runs[row], worst[row] = [], {}
        for kind in args.draws:
            for seed in range(args.first_seed, args.first_seed + args.seeds):
                stages = batched_stage_costs(model, row_plant(row), starts,
                                             staged_draws(kind, seed)).double()
                costs = stages.sum(-1).numpy()
                prefix = stages[:, :tys.PREFIX_STEPS].sum(-1).numpy()
                gap = tys.gaps(row, costs, prefix)
                for key, v in gap.items():
                    worst[row][key] = max(worst[row].get(key, 0.0), v)
                run = {"row": row, "draws": kind, "seed": seed, "costs": costs.tolist(),
                       "mean10": float(costs.mean()), "prefix": prefix.tolist(),
                       "prefix_mean10": float(prefix.mean()), "gaps": gap}
                runs[row].append(run)
                print(json.dumps(run), flush=True)
    result = {"runs": runs, "worst_gaps": worst,
              "bounds": {r: {key: 2 * v for key, v in g.items()} for r, g in worst.items()}}
    print(json.dumps({"worst_gaps": worst, "bounds": result["bounds"]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
