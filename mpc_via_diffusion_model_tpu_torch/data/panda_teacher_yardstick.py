"""The yardstick that the panda arm's CFG teacher is held to: the JAX
package's ``scripts/bench_highdim.py`` panda protocol on the CPU, as
literals. The teacher (``artifacts/flagship_panda_rbd/ema_params.pkl``, the
statistics of ``data/panda_stats.py``, which come from the same run's
``dataset.npz``) runs ``N_STEPS`` replans of the CFG DDPM chain (T = 25 + 5
noise-free steps, w = 0.01, K = 1) from x0 = 0.3 rad on every joint of the
shifted state at rest (``x0()``), the context of ``make_panda_context``, one
key of ``jax.random.split(PRNGKey(7), 10)`` per episode, through the JAX
package's ``make_closed_loop`` on ``model.apply``, jitted, seed by seed. Its
rows (``ROWS``):

- (a) ``chain``: the plant ``panda_rbd`` (``get_plant("panda")``), the loop
  the JAX script's chain and XLA rows run;
- (b) ``episode``: the same loop with ``panda_rbd_unrolled``, the plant the
  JAX episode kernel traces in. The JAX kernel matches that loop
  (ops/fused_episode.py:433-434); its Pallas kernels in interpret mode at
  H = 128 are too slow for the CPU, and its ``inkernel_noise`` needs a TPU.

``COSTS[row]`` is each episode's summed stage cost (the float32 stage costs
summed in float64), ``MEAN10[row]`` their mean; ``PREFIX_COSTS[row]`` each
episode's cost of its first ``PREFIX_STEPS`` replans, the cut that
chip_smoke.py's phase 48 runs, and ``PREFIX_MEAN10[row]`` their mean.

- (c) ``BOUNDS[row]``: how far the port's mean over the 10 episodes
  (``mean10``) and over their first ``PREFIX_STEPS`` replans (``prefix``)
  may lie from the yardstick's, set on the CPU before the port's kernels
  ran on the card, from ``scripts/panda_teacher_divergence.py``: the port's
  plain loop of the row over the 10 episodes as one batched loop, on 5
  torch-seeded staged draws and on the draws of 5 Philox seed families
  (``ops/philox.py::cfg_normal_table``, the in-kernel draw's; the card
  draws from other seeds). Each bound is twice the largest gap over those
  runs.
- (d) the paired gate (``PAIRED_PREFIX``, ``PAIRED_BOUND``): the port's
  plain episode on the CPU over the first ``PREFIX_STEPS`` replans of each
  of the 10 Philox seeds phase 48 draws from, and how far each episode on
  the card may lie from it (``scripts/panda_teacher_divergence.py
  --paired``, set after the first chip runs, which the mean gate alone had
  held). Over 20 replans the episodes do not part under fp32 differences,
  so this gate is some 40,000 times tighter than (c)'s and fails w = 0.

``tests/test_torch_port_panda_cfg.py::test_teacher_yardstick_regenerates``
recomputes (a) and (b) with the JAX package, and
``test_teacher_paired_prefix_regenerates`` (d)'s ``PAIRED_PREFIX`` (both
marked ``slow``: about 4 minutes and 1 minute on the CPU).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

__all__ = ["BOUNDS", "COSTS", "H", "KEY_SEED", "MEAN10", "N_SEEDS", "N_STEPS", "N_TAIL",
           "PAIRED_BOUND", "PAIRED_PREFIX", "PAIRED_SEED_BASE", "PREFIX_COSTS", "PREFIX_MEAN10",
           "PREFIX_STEPS", "ROWS", "T", "TEACHER", "W", "gaps", "paired_gaps", "paired_within",
           "within", "x0"]

TEACHER = (Path(__file__).resolve().parents[2] / "artifacts" / "flagship_panda_rbd"
           / "ema_params.pkl")
T, N_TAIL, W, H, N_SEEDS, N_STEPS, KEY_SEED, PREFIX_STEPS = 25, 5, 0.01, 128, 10, 80, 7, 20
PAIRED_SEED_BASE = 48_000
# row -> the plant its loop steps
ROWS = {"chain": "panda_rbd", "episode": "panda_rbd_unrolled"}


def x0() -> np.ndarray:
    """The protocol's start: 0.3 rad on every joint of the shifted state, at rest."""
    return np.concatenate([np.full(7, 0.3), np.zeros(7)]).astype(np.float32)


COSTS = {
    "chain": (
        242.55629086494446, 252.52938210964203, 251.0237295627594,
        243.07670640945435, 242.1267762184143, 242.22474133968353,
        247.7724997997284, 238.4761610031128, 267.4872735738754,
        242.05077826976776,),
    "episode": (
        242.55632877349854, 252.52939248085022, 251.02373230457306,
        243.07667481899261, 242.1267992258072, 242.22476625442505,
        247.7725260257721, 238.47614634037018, 267.48727011680603,
        242.05077385902405,),
}
PREFIX_COSTS = {
    "chain": (
        46.97573709487915, 66.52057826519012, 66.08505940437317,
        49.7925922870636, 46.158048152923584, 49.88616406917572,
        57.475038290023804, 39.0710723400116, 94.97235953807831,
        46.082554936409,),
    "episode": (
        46.975741147994995, 66.52057695388794, 66.0850635766983,
        49.792595744132996, 46.15804946422577, 49.88616967201233,
        57.475040674209595, 39.07107198238373, 94.97235870361328,
        46.08255410194397,),
}
MEAN10 = {row: float(np.mean(c)) for row, c in COSTS.items()}
PREFIX_MEAN10 = {row: float(np.mean(c)) for row, c in PREFIX_COSTS.items()}

# (c): twice the largest gap over scripts/panda_teacher_divergence.py's 10 runs per row (torch
# seeds 0-4 and Philox seed families 0-4, 3 threads). The teacher's episodes part into modes (a
# cost of ~238-243 or of ~250-290), so a mean of 10 moves by several units from one draw to the
# next; the largest gaps, both at the Philox family 2: chain 11.162802 (its first 20
# replans 17.373316), episode 11.162793 (17.373312).
BOUNDS: Dict[str, Dict[str, float]] = {
    "chain": {"mean10": 22.32560493946073, "prefix": 34.74663119316101},
    "episode": {"mean10": 22.325585699081387, "prefix": 34.74662380218507},
}


def gaps(row: str, costs=None, prefix_costs=None) -> Dict[str, float]:
    """|the mean of ``costs`` (one per episode, the 10 of the protocol) -
    MEAN10[row]| under ``mean10``, and |the mean of ``prefix_costs`` (their
    first PREFIX_STEPS replans) - PREFIX_MEAN10[row]| under ``prefix``, for
    those given."""
    out = {}
    if costs is not None:
        out["mean10"] = abs(float(np.mean(costs)) - MEAN10[row])
    if prefix_costs is not None:
        out["prefix"] = abs(float(np.mean(prefix_costs)) - PREFIX_MEAN10[row])
    return out


def within(row: str, costs=None, prefix_costs=None) -> bool:
    """Whether every gap lies within BOUNDS[row]."""
    return all(g <= BOUNDS[row][k] for k, g in gaps(row, costs, prefix_costs).items())


# (d) the paired gate: PAIRED_PREFIX[i] is the port's plain episode (panda_rbd_unrolled, the
# kernel's plain twin) on the CPU over the first PREFIX_STEPS replans of the draw seeded
# seed_from_generator(torch.Generator().manual_seed(PAIRED_SEED_BASE + i)) (cfg_normal_table),
# the seeds chip_smoke.py's phase 48 runs the drawing entry on; PAIRED_BOUND is twice the largest
# per-episode gap over scripts/panda_teacher_divergence.py --paired's fp32-sized perturbations.
# Over 20 replans the episodes do not part: eps moved by 1e-6 moved them by at most 7.0e-6, x0
# by one ulp 7.7e-6, every step's state by 1e-6 (the largest) 3.97e-4; the controls moved 8
# (w = 0, up to 6.2e-3) and 9 (the draw counter one replan on, up to 18.8) of the 10 past the
# bound.
PAIRED_PREFIX = (
    59.32094752788544, 49.97896194458008,
    84.68141376972198, 49.75683069229126,
    39.06931948661804, 55.07603847980499,
    89.17464470863342, 47.495224475860596,
    55.50281012058258, 65.27623879909515,
)
PAIRED_BOUND = 0.0007932186126708984


def paired_gaps(prefix_costs) -> list:
    """|prefix_costs[i] - PAIRED_PREFIX[i]| for each of the 10 paired episodes."""
    return [abs(float(c) - p) for c, p in zip(prefix_costs, PAIRED_PREFIX, strict=True)]


def paired_within(prefix_costs) -> bool:
    """Whether every paired episode lies within PAIRED_BOUND of the port's plain episode."""
    return max(paired_gaps(prefix_costs)) <= PAIRED_BOUND
