"""How far the port's iLQR expert parts from the JAX package's yardstick,
and how far two runs of the port part that differ by one ulp of their
initial states.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.ilqr_divergence [--device cpu] \\
        [--steps 80]

The line search's argmin and the accept test can flip on an ulp, so whole
solves are chaotic within a band: these are the numbers that the bounds of
``data/flagship_expert_yardstick.py`` are set from. Three configurations,
each run as it is and from initial states moved by one ulp (``PERTURBED``:
theta, theta* or both, up or down, in every initial state; the other
components of these states are 0, whose ulp is too small to move a solve):

- ``expert``: ``make_nmpc_closed_loop`` from the flagship's x0 (H = 32, 25
  iterations, kick 5), ``--steps`` steps; the relative gap of the summed
  stage costs and the largest control and state gaps over the first 5, 10
  and all steps;
- ``first_step``: one ``ilqr_solve`` over the 400 nominal first solves of
  the flagship collection (its grid times kicks +-5); the largest relative
  cost gap and first-control gap, and how many ``backward_ok`` differ;
- ``small_collection``: ``collect_closed_loop_dataset`` at the CPU tests'
  size (``SMALL``), its normals from ``torch.Generator`` seed 0; the largest
  control, condition and relative cost gaps over its rows.

Prints one JSON object: per configuration, the unperturbed run against the
yardstick's literals (expert and first step) and every perturbed run against
the unperturbed one.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from ..control import make_nmpc_closed_loop
from ..data import flagship_expert_yardstick as ys
from ..data.generation import collect_closed_loop_dataset
from ..dynamics import cartpole_virtual_cost, cartpole_virtual_swingup
from ..solvers import ILQRConfig, ilqr_solve
from ..utils.device import resolve_device

# (state components, direction): theta, theta* and both, each up and down
PERTURBED = (((2,), 1), ((2,), -1), ((4,), 1), ((4,), -1), ((2, 4), 1), ((2, 4), -1))


def nudge(x0: torch.Tensor, components, direction: int) -> torch.Tensor:
    """``x0`` (..., n) with some components of every state moved by one ulp."""
    out = x0.clone()
    for c in components:
        out[..., c] = torch.nextafter(x0[..., c], torch.full_like(x0[..., c], direction * np.inf))
    return out


def expert_runs(dev, n_steps: int, perturbed=PERTURBED) -> dict:
    loop = make_nmpc_closed_loop(cartpole_virtual_swingup(), cartpole_virtual_cost(),
                                 ILQRConfig(ys.HORIZON, ys.ITERATIONS), n_steps=n_steps,
                                 u_init_scale=ys.KICKS[0], device=dev)
    x0 = torch.tensor(ys.EXPERT_X0, device=dev)
    t0 = time.perf_counter()
    base = loop(x0)
    s_per_run = time.perf_counter() - t0
    windows = sorted({min(w, n_steps) for w in (5, 10, n_steps)})
    out = {"steps": n_steps, "s_per_run": s_per_run,
           "vs_yardstick": {w: ys.expert_gaps(base, w) for w in windows}, "perturbed": []}
    for comp, sign in perturbed:
        run = loop(nudge(x0, comp, sign))
        want = (base.u_track, base.x_track, base.stage_costs)
        out["perturbed"].append({"components": comp, "direction": sign,
                                 **{w: ys.expert_gaps(run, w, want) for w in windows}})
    return out


def first_step_runs(dev, perturbed=PERTURBED) -> dict:
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_cost()
    x0, u_init = (t.to(dev) for t in ys.first_step_batch())
    cfg = ILQRConfig(ys.HORIZON, ys.ITERATIONS)
    t0 = time.perf_counter()
    base = ilqr_solve(plant, cost, x0, u_init, cfg)
    out = {"solves": len(x0), "s": time.perf_counter() - t0,
           "vs_yardstick": ys.first_step_gaps(base), "perturbed": []}
    for comp, sign in perturbed:
        sol = ilqr_solve(plant, cost, nudge(x0, comp, sign), u_init, cfg)
        out["perturbed"].append({"components": comp, "direction": sign,
                                 **ys.first_step_gaps(sol, base)})
    return out


def small_runs(dev, perturbed=PERTURBED) -> dict:
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_cost()
    grid = torch.from_numpy(ys.small_grid())
    normals = torch.randn(ys.small_noise_shape(), generator=torch.Generator().manual_seed(0))

    def run(g):
        return collect_closed_loop_dataset(plant, cost, g.numpy(), noise=normals,
                                           return_arrays=True, device=dev, **ys.SMALL)

    base = run(grid)
    out = {"rows": len(base[0]), "perturbed": []}
    for comp, sign in perturbed:
        out["perturbed"].append({"components": comp, "direction": sign,
                                 **ys.collection_gaps(run(nudge(grid, comp, sign)), base)})
    return out


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--steps", type=int, default=ys.N_STEPS)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"device": str(dev), "threads": torch.get_num_threads(),
           "small_collection": small_runs(dev), "first_step": first_step_runs(dev),
           "expert": expert_runs(dev, args.steps)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
