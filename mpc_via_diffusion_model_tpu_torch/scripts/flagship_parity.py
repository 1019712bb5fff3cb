"""The flagship's control quality through the port, by the evaluation
protocol of ``scripts/flagship_run.py:246-330``.

    python -m mpc_via_diffusion_model_tpu_torch.scripts.flagship_parity [--device cpu] [--seeds 10]

Ten K = 1 closed loops of 80 replans from x0 = [0, 0, 3.0, 0, theta*(3.0)],
each on the draws of a ``torch.Generator`` seeded with its index, at w = 0.01
and 25 + 5 steps, scored with ``cartpole_virtual_cost``; the flagship's
weights (``artifacts/flagship/ema_params.pkl``) and its dataset's normalizer
statistics (``data/flagship_stats.py``). Each loop is ``make_closed_loop``
with the CFG chain kernel as its ``sample_override`` (its plain version on
the CPU), which also gives the applied horizons that ``per_step_mpc_costs``
scores. Prints one JSON object beside ``artifacts/flagship/report.json``'s
numbers: the mean closed-loop cost against the diffusion controller's and the
expert's, their ratio to the expert's, the mean horizon cost, the modality,
and ``track_parity`` of seed 0 against the expert's tracks. The expert is
the JAX package's iLQR expert on the CPU (``data/flagship_expert_yardstick.py``,
(a): cost 784,750.03), which the port's own expert is held to; the report's
expert figures (its TPU run: 784,750.6) stay beside it under
their keys. The draws are torch's, not JAX's, so the comparison is
distributional. ``run_episode_quality`` runs the same ten loops through the
CFG episode kernel (one launch of 80 replans per seed) for
``chip_smoke.py``, with the closed-loop costs and the modality.
"""
from __future__ import annotations

import argparse
import json
import types
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..control import count_swing_modes, make_closed_loop, per_step_mpc_costs, track_parity
from ..core import make_schedule
from ..data import flagship_expert_yardstick as ys
from ..data.flagship_stats import flagship_stats
from ..diffusion import GaussianDiffusion
from ..dynamics import cartpole_virtual_cost, cartpole_virtual_swingup, theta_to_red_theta
from ..models import load_flagship
from ..ops.fused_denoise import make_fused_cfg_chain
from ..ops.fused_episode import make_fused_cfg_episode
from ..utils.device import resolve_device

ARTIFACTS = Path(__file__).resolve().parents[2] / "artifacts" / "flagship"
HORIZON, T, N_TAIL, W = 32, 25, 5, 0.01


def run_parity(device=None, n_seeds: int = 10, n_steps: int = 80) -> dict:
    """The protocol's numbers on ``device`` (``cuda`` unless given), beside
    the report's; ``chain_launches`` counts the kernel's launches."""
    dev = resolve_device(device)
    model = load_flagship(ARTIFACTS / "ema_params.pkl", device=dev)
    schedule = make_schedule("exponential", T)
    chain = make_fused_cfg_chain(model, schedule, n_samples=1, w=W, n_tail=N_TAIL, device=dev)
    inputs_stats, condition_stats = flagship_stats()
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_cost()
    loop = make_closed_loop(GaussianDiffusion(schedule), model, inputs_stats, condition_stats,
                            plant, cost, horizon=HORIZON, n_steps=n_steps, w=W,
                            n_diffusion_steps_without_noise=N_TAIL, sample_override=chain,
                            device=dev)
    x0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    runs = [loop(x0, generator=torch.Generator(device=dev).manual_seed(seed))
            for seed in range(n_seeds)]
    cost = cost.to(dev)
    closed_loop = [r.stage_costs.double().sum().item() for r in runs]
    horizon = [per_step_mpc_costs(plant, cost, r).double().sum().item() for r in runs]
    u_mpc, x_mpc, _ = ys.expert_tracks()
    expert = types.SimpleNamespace(x_track=x_mpc, u_track=u_mpc)
    report = json.loads((ARTIFACTS / "report.json").read_text())
    mean = float(np.mean(closed_loop))
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "seeds": n_seeds, "n_steps": n_steps, "chain_launches": chain.launches,
        "closed_loop_costs": closed_loop, "closed_loop_cost_mean": mean,
        "closed_loop_cost_report": report["closed_loop_cost_diffusion_mean10"],
        "closed_loop_cost_nmpc": report["closed_loop_cost_nmpc"], "expert_cost": ys.EXPERT_COST,
        "cost_over_expert": mean / ys.EXPERT_COST,
        "horizon_cost_mean": float(np.mean(horizon)),
        "horizon_cost_report": report["horizon_cost_diffusion_mean10"],
        "horizon_cost_nmpc": report["horizon_cost_nmpc"],
        "modality": count_swing_modes(torch.stack([r.x_track for r in runs])),
        "modality_report": report["modality"],
        "parity": track_parity(runs[0], expert), "parity_report": report["parity"],
    }


def run_episode_quality(device=None, n_seeds: int = 10, n_steps: int = 80,
                        weights_dtype=torch.float32) -> dict:
    """The protocol's K = 1 loops through the CFG episode kernel on
    ``device`` (``cuda`` unless given; its plain version on the CPU), each
    seed's staged noise one draw of a ``torch.Generator`` seeded with its
    index: the closed-loop costs, their mean over the expert's and the
    modality, beside the report's. ``episode_launches`` counts the kernel's
    launches; ``weights_dtype`` is the episode's (bfloat16: its bf16 entry)."""
    dev = resolve_device(device)
    model = load_flagship(ARTIFACTS / "ema_params.pkl", device=dev)
    inputs_stats, condition_stats = flagship_stats()
    ep = make_fused_cfg_episode(model, make_schedule("exponential", T), inputs_stats,
                                condition_stats, cartpole_virtual_swingup(), cartpole_virtual_cost(),
                                n_steps=n_steps, w=W, n_diffusion_steps_without_noise=N_TAIL,
                                weights_dtype=weights_dtype, device=dev)
    x0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    runs = [ep(x0, torch.randn(ep.noise_shape, generator=torch.Generator(device=dev).manual_seed(seed),
                               device=dev)) for seed in range(n_seeds)]
    report = json.loads((ARTIFACTS / "report.json").read_text())
    closed_loop = [costs.double().sum().item() for _, _, costs in runs]
    mean = float(np.mean(closed_loop))
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "seeds": n_seeds, "n_steps": n_steps, "episode_launches": ep.launches,
        "closed_loop_costs": closed_loop, "closed_loop_cost_mean": mean,
        "closed_loop_cost_nmpc": report["closed_loop_cost_nmpc"], "expert_cost": ys.EXPERT_COST,
        "cost_over_expert": mean / ys.EXPERT_COST,
        "modality": count_swing_modes(torch.stack([x for x, _, _ in runs])),
        "modality_report": report["modality"],
    }


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--seeds", type=int, default=10)
    args = p.parse_args(argv)
    out = run_parity(args.device, args.seeds)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
