"""The LMPC parity workload through the port: the linear cart-pole at
horizon 8, the diffusion controller against the receding-horizon LQR
expert, by the evaluation of ``scripts/flagship_lmpc.py``'s step 3.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.lmpc_parity [--device cpu] \\
        [--route episode|chain] [--states 16] [--steps 50] [--candidates 1 8]

The 16 initial states of the sweep (``RandomState(30)``: ``randint(3, 12,
16)`` twice into the reference's 15 x 15 grid of position and angle,
velocities 0); 50 replans each; T = 25 exponential steps and 5 noise-free
tail steps, w = 0.01; one sample or 8 candidates, the first control of the
one whose 8-step rollout costs least. The expert is the LQR controller with
gains precomputed once (``solvers/lqr.py``), re-solved from every state.
``track_parity`` of each run against the expert's gives sum |u_diffusion -
u_lqr| (u_l1) and its largest step (u_l1_max). The committed weights
(``artifacts/flagship_lmpc/ema_params.pkl``, ``models.load_lmpc``) and the
statistics they were trained on (``data/lmpc_stats.py``).

Routes: ``episode`` (default) runs each state's 50 replans as one launch of
the CFG episode kernel's linear cart-pole entry (``cfg_episode_lmpc``);
``chain`` runs ``make_closed_loop`` with the CFG chain kernel as its
``sample_override``, the JAX script's route. On the CPU both run their plain
versions. The noise of state i is one draw of a ``torch.Generator`` seeded
7 + i on the device, in the episode's layout, which both routes take.
Prints one JSON object with ``artifacts/flagship_lmpc/report.json``'s keys
(``u_l1_mean``/``median``/``best``/``worst``, ``u_step_max_mean``,
``candidates8``), each state's u_l1, and beside them the JAX package's loop
on the CPU (``data/lmpc_stats.py``'s ``LMPC_U_L1``) and the report's.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..control import ClosedLoopResult, make_closed_loop, track_parity
from ..core import make_schedule
from ..data.lmpc_stats import LMPC_U_L1, LMPC_U_L1_SUMMARY, lmpc_stats
from ..data.normalization import NormalizerStats
from ..diffusion import GaussianDiffusion
from ..dynamics import Plant, cartpole_lmpc, cartpole_lmpc_cost
from ..models import load_lmpc
from ..ops.fused_denoise import make_fused_cfg_chain
from ..ops.fused_episode import make_fused_cfg_episode
from ..solvers import lqr_gains, lqr_solve
from ..utils.device import resolve_device

ARTIFACTS = Path(__file__).resolve().parents[2] / "artifacts" / "flagship_lmpc"
HORIZON, T, N_TAIL, W, N_STEPS, N_STATES, NOISE_SEED = 8, 25, 5, 0.01, 50, 16, 7
KEYS = ("u_l1_mean", "u_l1_median", "u_l1_best", "u_l1_worst", "u_step_max_mean")


def sweep_states(n_states: int = N_STATES) -> torch.Tensor:
    """(n_states, 4) initial states: interior points of the reference's 15 x
    15 grid of position in [-1, 1] and angle in [-pi/4, pi/4], velocities 0,
    drawn as the JAX script draws them."""
    pos, theta = np.linspace(-1, 1, 15), np.linspace(-np.pi / 4, np.pi / 4, 15)
    rng = np.random.RandomState(30)
    idx_p, idx_t = rng.randint(3, 12, N_STATES), rng.randint(3, 12, N_STATES)
    x0s = np.zeros((N_STATES, 4), np.float32)
    x0s[:, 0], x0s[:, 2] = pos[idx_p], theta[idx_t]
    return torch.from_numpy(x0s[:n_states])


def linear_matrices(plant: Plant, cost, device=None):
    """(A, B, Q, R, P) float32 of a linear plant and a quadratic cost, A and
    B read off the plant's step as the JAX script reads them (exact: each
    column is one step from a unit state)."""
    n = plant.state_dim
    eye, zero_u = torch.eye(n, device=device), torch.zeros((n, plant.control_dim), device=device)
    a = plant.step(eye, zero_u).T
    b = plant.step(torch.zeros((1, n), device=device), torch.ones((1, plant.control_dim),
                                                                   device=device)).T
    cost = cost.to(device)
    return a, b, torch.diag(cost.q_diag), cost.r.reshape(1, 1), torch.diag(cost.p_diag)


def expert_loop(plant: Plant, cost, x0s: torch.Tensor, n_steps: int = N_STEPS) -> ClosedLoopResult:
    """The receding-horizon LQR expert from every state of ``x0s`` (N, 4) at
    once: each step the first control of ``lqr_solve`` with gains computed
    once. Tracks carry the batch axis first."""
    a, b, q, r, p = linear_matrices(plant, cost, x0s.device)
    ks = lqr_gains(a, b, q, r, p, HORIZON)
    cost = cost.to(x0s.device)
    x, xs, us, u_hors, stages = x0s, [x0s], [], [], []
    for _ in range(n_steps):
        sol = lqr_solve(a, b, q, r, p, x, HORIZON, gains=ks)
        u0 = sol.us[:, 0]
        stages.append(cost.stage(x, u0))
        x = plant.step(x, u0)
        xs.append(x)
        us.append(u0)
        u_hors.append(sol.us)
    stack = lambda v: torch.stack(v, dim=1)
    return ClosedLoopResult(stack(xs), stack(us), stack(u_hors), stack(stages))


def state_noise(i: int, shape: Sequence[int], device) -> torch.Tensor:
    """The staged noise of sweep state i: one draw of a generator seeded 7 + i."""
    gen = torch.Generator(device=device).manual_seed(NOISE_SEED + i)
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=device)


class Controller:
    """The diffusion controller of one route and K: ``run(x0, noise) ->
    (x_track, u_track, chosen)`` (``chosen`` the applied candidate of every
    replan on the episode route, None on the chain route), ``noise_shape``,
    and ``wrapper``, the kernel wrapper whose ``launches`` count the route's
    launches."""

    def __init__(self, model, route: str, n_candidates: int, n_steps: int, device,
                 stats: Optional[Tuple[NormalizerStats, NormalizerStats]] = None):
        ins, cond = stats or lmpc_stats()
        plant, cost, schedule = cartpole_lmpc(), cartpole_lmpc_cost(), make_schedule("exponential", T)
        self.route = route
        if route == "episode":
            self.wrapper = make_fused_cfg_episode(
                model, schedule, ins, cond, plant, cost, n_steps=n_steps, w=W,
                n_diffusion_steps_without_noise=N_TAIL, n_candidates=n_candidates, device=device)
            self.noise_shape = self.wrapper.noise_shape
        elif route == "chain":
            self.wrapper = make_fused_cfg_chain(model, schedule, n_samples=n_candidates, w=W,
                                                n_tail=N_TAIL, device=device)
            self._loop = make_closed_loop(
                GaussianDiffusion(schedule), model, ins, cond, plant, cost, horizon=HORIZON,
                n_steps=n_steps, w=W, n_diffusion_steps_without_noise=N_TAIL,
                n_candidates=n_candidates, sample_override=self.wrapper, device=device)
            self.noise_shape = (n_steps, T + N_TAIL + 1, n_candidates, HORIZON, 1)
        else:
            raise ValueError(f"route must be 'episode' or 'chain', not {route!r}")

    def run(self, x0: torch.Tensor, noise: torch.Tensor):
        if self.route == "episode":
            x_track, u_track, _ = self.wrapper(x0, noise)
            return x_track, u_track, self.wrapper.last_chosen
        res = self._loop(x0, noise)
        return res.x_track, res.u_track, None


def summarize(u_l1: Sequence[float], u_max: Sequence[float]) -> dict:
    """report.json's keys of one set of runs."""
    return dict(zip(KEYS, (float(np.mean(u_l1)), float(np.median(u_l1)), float(np.min(u_l1)),
                           float(np.max(u_l1)), float(np.mean(u_max)))))


def run(device=None, route: str = "episode", n_states: int = N_STATES, n_steps: int = N_STEPS,
        candidates: Sequence[int] = (1, 8), model=None,
        stats: Optional[Tuple[NormalizerStats, NormalizerStats]] = None) -> dict:
    """The parity numbers on ``device`` (``cuda`` unless given) for each K of
    ``candidates`` over the first ``n_states`` sweep states, beside the JAX
    package's and the report's, of ``model`` (the committed weights unless
    given) with the normalizer statistics ``stats`` (inputs, condition;
    ``lmpc_stats()`` unless given). The episode route runs the states as one
    fleet (one launch per K); ``launches`` counts each K's kernel launches;
    ``tracks`` holds each K's (x_track, u_track, chosen) per state."""
    dev = resolve_device(device)
    model = model if model is not None else load_lmpc(ARTIFACTS / "ema_params.pkl", device=dev)
    x0s = sweep_states(n_states).to(dev)
    expert = expert_loop(cartpole_lmpc(), cartpole_lmpc_cost(), x0s, n_steps)
    report = json.loads((ARTIFACTS / "report.json").read_text())
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "route": route, "n_states": n_states, "n_steps": n_steps,
           "x0s": x0s.tolist(), "launches": {}, "per_state_u_l1": {}, "tracks": {}}
    for k in candidates:
        ctl = Controller(model, route, k, n_steps, dev, stats)
        u_l1, u_max, tracks = [], [], []
        noise = [state_noise(i, ctl.noise_shape, dev) for i in range(n_states)]
        if route == "episode":  # every state's episode as one fleet: one launch
            fleet = ctl.wrapper.fleet(x0s, torch.stack(noise))
            runs = list(zip(fleet[0], fleet[1], ctl.wrapper.last_chosen))
        else:
            runs = [ctl.run(x0s[i], noise[i]) for i in range(n_states)]
        for i, (x_track, u_track, chosen) in enumerate(runs):
            tracks.append((x_track, u_track, chosen))
            par = track_parity(ClosedLoopResult(x_track, u_track, None, None),
                               ClosedLoopResult(expert.x_track[i], expert.u_track[i], None, None))
            u_l1.append(par["u_l1"])
            u_max.append(par["u_l1_max"])
        summary = summarize(u_l1, u_max)
        if k == 1:
            out.update(summary)
        else:
            out[f"candidates{k}"] = summary
        out["launches"][k] = ctl.wrapper.launches
        out["per_state_u_l1"][k] = u_l1
        out["tracks"][k] = tracks
    out["jax_cpu"] = {**dict(zip(KEYS[:4], LMPC_U_L1_SUMMARY)),
                      "per_state_u_l1": list(LMPC_U_L1[:n_states])}
    out["report"] = {key: report[key] for key in KEYS}
    out["report"]["candidates8"] = report["candidates8"]
    return out


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--route", default="episode", choices=("episode", "chain"))
    p.add_argument("--states", type=int, default=N_STATES)
    p.add_argument("--steps", type=int, default=N_STEPS)
    p.add_argument("--candidates", type=int, nargs="+", default=[1, 8])
    args = p.parse_args(argv)
    out = run(args.device, args.route, args.states, args.steps, args.candidates)
    print(json.dumps({k: v for k, v in out.items() if k != "tracks"}), flush=True)
    return out


if __name__ == "__main__":
    main()
