"""The yardstick that the panda student's serving path is held to: the JAX
package's ``scripts/bench_panda_student.py`` protocol on the CPU, as
literals. The on-policy 1-eval student
(``artifacts/onpolicy_panda/student_1eval.pkl``, times grid ``TIMES``, the
statistics of ``data/panda_stats.py``) runs ``N_STEPS`` replans from x0 =
0.3 rad on every joint of the shifted state (``x0()``), the context of
``make_panda_context``, one key of ``jax.random.split(PRNGKey(7), 10)`` per
episode, through the JAX package's ``make_closed_loop`` with the student's
DDIM sampler as ``sample_override``, jitted, seed by seed. Its rows
(``ROWS``: K and the selection horizon):

- (a) ``k1`` and ``k16_selh32``: the chain split, the plant ``panda_rbd``;
- (b) ``episode`` and ``episode_k4_selh16``: the whole-episode kernel's
  rows, the same loop with ``panda_rbd_unrolled``, the plant the JAX episode
  kernel traces in (it matches ``make_closed_loop`` step for step,
  ops/fused_episode.py:161-164).

``COSTS[row]`` is each episode's summed stage cost (the float32 stage costs
summed in float64), ``MEAN10[row]`` their mean; ``PREFIX_COSTS[row]`` each
episode's cost of its first ``PREFIX_STEPS[row]`` replans, for the rows the
card runs cut short (``k16_selh32``: its eager arm rollouts are
launch-bound).

- (c) ``BOUNDS[row]``: how far the port's mean over the 10 episodes (and,
  where cut, over their prefixes) may lie from the yardstick's, set on the
  CPU before the port ran on the card, from
  ``scripts/panda_divergence.py``: the port's rows with its own noise (torch
  seeds 0-2; the card draws from other seeds), each also from x0 moved by
  one ulp up and down. Each bound is twice the largest gap over those runs.

``tests/test_torch_port_panda.py::test_yardstick_regenerates`` recomputes
(a) and (b) with the JAX package (marked ``slow``: about 2.5 minutes on the
CPU).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

__all__ = ["BOUNDS", "COSTS", "H", "KEY_SEED", "MEAN10", "N_SEEDS", "N_STEPS", "PREFIX_COSTS",
           "PREFIX_STEPS", "ROWS", "STUDENT", "T", "TIMES", "gaps", "within", "x0"]

STUDENT = Path(__file__).resolve().parents[2] / "artifacts" / "onpolicy_panda" / "student_1eval.pkl"
T, TIMES, H, N_SEEDS, N_STEPS, KEY_SEED = 25, [23], 128, 10, 80, 7
# row -> (K, selection_horizon): the JAX script's rows
ROWS = {"k1": (1, None), "k16_selh32": (16, 32), "episode": (1, None),
        "episode_k4_selh16": (4, 16)}
PREFIX_STEPS = {"k16_selh32": 20}


def x0() -> np.ndarray:
    """The protocol's start: 0.3 rad on every joint of the shifted state, at rest."""
    return np.concatenate([np.full(7, 0.3), np.zeros(7)]).astype(np.float32)


COSTS = {
    "k1": (
        239.1092323064804, 239.11391353607178, 239.01983451843262, 239.30524456501007,
        238.46752452850342, 238.9078837633133, 239.51540887355804, 239.7765128016472,
        239.51521265506744, 238.9320079088211,),
    "k16_selh32": (
        237.81456816196442, 237.505429148674, 237.0300179719925, 236.93157172203064,
        237.6514163017273, 237.06435358524323, 237.08361208438873, 238.06166219711304,
        237.38163423538208, 237.20682406425476,),
    "episode": (
        239.10926961898804, 239.1139075756073, 239.01986944675446, 239.30523824691772,
        238.46755051612854, 238.9078916311264, 239.51543164253235, 239.77647095918655,
        239.51526808738708, 238.93201804161072,),
    "episode_k4_selh16": (
        238.1994755268097, 237.68404531478882, 237.81547141075134, 237.91083216667175,
        238.15773499011993, 237.81865644454956, 238.00737345218658, 239.2757134437561,
        237.4098961353302, 237.7429518699646,),
}
MEAN10 = {row: float(np.mean(c)) for row, c in COSTS.items()}
PREFIX_COSTS = {
    "k16_selh32": (
        36.35922181606293, 37.3869868516922, 37.41461408138275, 37.20126724243164,
        36.56790852546692, 36.766645550727844, 37.09121930599213, 37.059895515441895,
        36.96296000480652, 37.355329275131226,),
}

# (c): twice the largest gap over scripts/panda_divergence.py's 24 runs per row (torch seeds
# 0-7, each from x0 as it is and moved by one ulp up and down; one ulp moved a mean by at most
# 3e-5, and 0.013 at K = 16 where a candidate choice flipped, so the draws make the spread). The
# largest gaps: k1 0.510166, k16_selh32 0.366040 (its
# first 20 replans 0.491162), episode 0.510146, episode_k4_selh16 0.286693.
BOUNDS: Dict[str, Dict[str, float]] = {
    "k1": {"mean10": 1.020331704616524},
    "k16_selh32": {"mean10": 0.732079911232006, "prefix": 0.9823233842849817},
    "episode": {"mean10": 1.0202922940254666},
    "episode_k4_selh16": {"mean10": 0.5733863472938765},
}


def gaps(row: str, costs, prefix_costs=None) -> Dict[str, float]:
    """|the mean of ``costs`` (one per episode, the 10 of the protocol) -
    MEAN10[row]| under ``mean10``, and for a cut row |the mean of
    ``prefix_costs`` - the yardstick's prefix mean| under ``prefix``."""
    out = {"mean10": abs(float(np.mean(costs)) - MEAN10[row])} if costs is not None else {}
    if prefix_costs is not None:
        out["prefix"] = abs(float(np.mean(prefix_costs)) - float(np.mean(PREFIX_COSTS[row])))
    return out


def within(row: str, costs, prefix_costs=None) -> bool:
    """Whether every gap lies within BOUNDS[row]."""
    return all(g <= BOUNDS[row][k] for k, g in gaps(row, costs, prefix_costs).items())
