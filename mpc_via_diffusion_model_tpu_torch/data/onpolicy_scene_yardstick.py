"""The yardstick of ``scripts/onpolicy_scene.py``: the JAX package's script
at a toy size on the CPU, as literals.

``TOY_ARGS``: one iteration, 2 scenes x 2 starts x 10 replans, K = 4 with
the LQR candidate, 200 train steps in chunks of 50 at batch 64, the
held-out evaluation at 2 scenes x 2 starts x 10 replans; the first student
the committed scene student, the mixed-in data (``--scene-dir``) the
making half's ``--quick`` output (JAX's own for ``METRICS``, the port's for
the port). ``PAIRS`` holds the (state, scene) pairs the collection kept,
``METRICS[row]`` each row's ``track_metrics`` (rows ``before_k1``,
``before_k4``, ``onpolicy_k1``, ``onpolicy_k4``).

``BOUNDS``: twice the largest gap of each number over
``scripts/scene_making_divergence.py``'s port runs on the CPU (torch seeds
0-4), a fraction's at least 2 of its 4 pairs. Regenerated by
``tests/test_torch_port_scene_making.py::test_onpolicy_scene_yardstick_regenerates``
(``slow``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

__all__ = ["TOY_ARGS", "METRICS_KEYS", "ROWS", "PAIRS", "METRICS", "BOUNDS", "gaps", "within"]

_INIT = Path("artifacts") / "scene_conditioned" / "scene_student_ema.pkl"
TOY_ARGS = ("--init-student", str(_INIT), "--iterations", "1", "--collect-scenes", "2",
            "--collect-starts", "2", "--steps", "10", "--label-k", "4", "--lqr-candidate",
            "--train-steps", "200", "--chunk", "50", "--batch-size", "64", "--eval-scenes", "2",
            "--eval-starts", "2")
METRICS_KEYS = ("collision_free_fraction", "min_clearance_mean", "goal_dist_mean",
                "goal_reach_fraction_0.5", "safe_reach_fraction")
ROWS = ("before_k1", "before_k4", "onpolicy_k1", "onpolicy_k4")

PAIRS = 40
METRICS: Dict[str, Dict[str, float]] = {
    "before_k1": {
        "collision_free_fraction": 1.0, "min_clearance_mean": 0.6029040813446045,
        "goal_dist_mean": 2.475076913833618, "goal_reach_fraction_0.5": 0.0,
        "safe_reach_fraction": 0.0},
    "before_k4": {
        "collision_free_fraction": 1.0, "min_clearance_mean": 0.6066197156906128,
        "goal_dist_mean": 2.46769380569458, "goal_reach_fraction_0.5": 0.0,
        "safe_reach_fraction": 0.0},
    "onpolicy_k1": {
        "collision_free_fraction": 1.0, "min_clearance_mean": 0.6018864512443542,
        "goal_dist_mean": 2.4682860374450684, "goal_reach_fraction_0.5": 0.0,
        "safe_reach_fraction": 0.0},
    "onpolicy_k4": {
        "collision_free_fraction": 1.0, "min_clearance_mean": 0.6039049029350281,
        "goal_dist_mean": 2.461543560028076, "goal_reach_fraction_0.5": 0.0,
        "safe_reach_fraction": 0.0},
}
# twice the largest gap over scripts/scene_making_divergence.py's 5 port runs (torch seeds 0-4) on
# the CPU, a fraction's at least 2 of its 4 pairs, the collected pairs' at least 2. The largest
# gaps: pairs pairs 0.000000; before_k1 collision_free_fraction 0.000000, min_clearance_mean
# 0.003317, goal_dist_mean 0.005010, goal_reach_fraction_0.5 0.000000, safe_reach_fraction
# 0.000000; before_k4 collision_free_fraction 0.000000, min_clearance_mean 0.003138, goal_dist_mean
# 0.005761, goal_reach_fraction_0.5 0.000000, safe_reach_fraction 0.000000; onpolicy_k1
# collision_free_fraction 0.000000, min_clearance_mean 0.003289, goal_dist_mean 0.004404,
# goal_reach_fraction_0.5 0.000000, safe_reach_fraction 0.000000; onpolicy_k4
# collision_free_fraction 0.000000, min_clearance_mean 0.002902, goal_dist_mean 0.007145,
# goal_reach_fraction_0.5 0.000000, safe_reach_fraction 0.000000.
BOUNDS: Dict[str, Dict[str, float]] = {
    "pairs": {
        "pairs": 2.0},
    "before_k1": {
        "collision_free_fraction": 0.5, "min_clearance_mean": 0.006634, "goal_dist_mean":
        0.010021, "goal_reach_fraction_0.5": 0.5, "safe_reach_fraction": 0.5},
    "before_k4": {
        "collision_free_fraction": 0.5, "min_clearance_mean": 0.006277, "goal_dist_mean":
        0.011523, "goal_reach_fraction_0.5": 0.5, "safe_reach_fraction": 0.5},
    "onpolicy_k1": {
        "collision_free_fraction": 0.5, "min_clearance_mean": 0.006578, "goal_dist_mean":
        0.008809, "goal_reach_fraction_0.5": 0.5, "safe_reach_fraction": 0.5},
    "onpolicy_k4": {
        "collision_free_fraction": 0.5, "min_clearance_mean": 0.005805, "goal_dist_mean":
        0.014291, "goal_reach_fraction_0.5": 0.5, "safe_reach_fraction": 0.5},
}


def gaps(got: dict) -> Dict[str, Dict[str, float]]:
    """|got - the yardstick's| of every bounded number: ``got`` holds
    ``pairs`` and ``rows`` (row -> metrics)."""
    out = {"pairs": {"pairs": abs(got["pairs"] - PAIRS)}}
    for row in ROWS:
        out[row] = {m: abs(got["rows"][row][m] - METRICS[row][m]) for m in BOUNDS[row]}
    return out


def within(got: dict) -> bool:
    """Whether every gap lies within its bound."""
    return all(g <= BOUNDS[row][m] for row, gs in gaps(got).items() for m, g in gs.items())
