"""The yardstick of the scene study's making half
(``scripts/scene_conditioned_quadrotor.py --make``): the JAX package's
making half on the CPU at ``--quick`` size, as literals.

At ``--quick`` (2 chunks x 256 rows; 400 fine-tune steps in chunks of 100 at
batch 64; the evaluation 2 scenes x 4 starts x 20 replans, K = 4):
``MAKING`` holds the drawn and kept rows, the keep fraction, the kept rows'
mean clearance from their scenes, the first 20 per-step fine-tune losses
and the final loss (the last chunk's mean); ``METRICS[row]`` the made
student's rows (``scene_conditioned_student``, ``_k4``,
``canonical_scene_student``), each ``track_metrics`` over its pairs. The
teacher's rows (scene-blind, oracle) do not depend on the making and are
held by ``data/guided_yardstick.py``.

``BOUNDS``: twice the largest gap of each number over
``scripts/scene_making_divergence.py``'s port runs on the CPU (torch seeds
0-4; the port draws from torch generators, so its data, draws and noise
differ from JAX's), a fraction's at least 2 of its count (512 rows, 8 pairs,
4 canonical starts); ``first_losses`` bounds the largest gap over the 20
steps. Regenerated by
``tests/test_torch_port_scene_making.py::test_scene_making_yardstick_regenerates``
(``slow``).
"""
from __future__ import annotations

from typing import Dict

__all__ = ["ROWS", "MAKING", "METRICS", "BOUNDS", "gaps", "within"]

ROWS = ("scene_conditioned_student", "scene_conditioned_student_k4", "canonical_scene_student")

MAKING: Dict[str, object] = {
    "n_drawn": 512, "n_kept": 212, "keep_fraction": 0.4140625,
    "kept_clearance_mean": 0.4292651414871216,
    "first_losses": (
        0.29171326756477356, 0.4330868124961853, 0.359351247549057,
        0.2850362956523895, 0.273586630821228, 0.34955596923828125,
        0.3831603527069092, 0.26366350054740906, 0.3494868874549866,
        0.3328380286693573, 0.41871345043182373, 0.29920724034309387,
        0.3296689987182617, 0.3337498605251312, 0.3307468295097351,
        0.31651079654693604, 0.4012189507484436, 0.3407168388366699,
        0.3643782138824463, 0.3048345744609833),
    "final_loss": 0.2697409689426422,
}
METRICS: Dict[str, Dict[str, float]] = {
    "scene_conditioned_student": {
        "collision_free_fraction": 1.0, "min_clearance_mean": 0.4941076934337616,
        "goal_dist_mean": 2.4166171550750732, "goal_reach_fraction_0.5": 0.0,
        "safe_reach_fraction": 0.0},
    "scene_conditioned_student_k4": {
        "collision_free_fraction": 1.0, "min_clearance_mean": 0.5084820985794067,
        "goal_dist_mean": 2.4176149368286133, "goal_reach_fraction_0.5": 0.0,
        "safe_reach_fraction": 0.0},
    "canonical_scene_student": {
        "collision_free_fraction": 1.0, "min_clearance_mean": 0.40432775020599365,
        "goal_dist_mean": 2.410013437271118, "goal_reach_fraction_0.5": 0.0,
        "safe_reach_fraction": 0.0},
}
# twice the largest gap over scripts/scene_making_divergence.py's 5 port runs (torch seeds 0-4) on
# the CPU, a fraction's at least 2 of its count. The largest gaps: making keep_fraction 0.035156,
# kept_clearance_mean 0.025129, first_losses 0.149377, final_loss 0.007712;
# scene_conditioned_student collision_free_fraction 0.125000, min_clearance_mean 0.086646,
# goal_dist_mean 0.072224, goal_reach_fraction_0.5 0.000000, safe_reach_fraction 0.000000;
# scene_conditioned_student_k4 collision_free_fraction 0.125000, min_clearance_mean 0.087860,
# goal_dist_mean 0.088257, goal_reach_fraction_0.5 0.000000, safe_reach_fraction 0.000000;
# canonical_scene_student collision_free_fraction 0.250000, min_clearance_mean 0.120479,
# goal_dist_mean 0.102518, goal_reach_fraction_0.5 0.000000, safe_reach_fraction 0.000000.
BOUNDS: Dict[str, Dict[str, float]] = {
    "making": {
        "keep_fraction": 0.070313, "kept_clearance_mean": 0.050258, "first_losses": 0.298754,
        "final_loss": 0.015425},
    "scene_conditioned_student": {
        "collision_free_fraction": 0.25, "min_clearance_mean": 0.173293, "goal_dist_mean":
        0.144449, "goal_reach_fraction_0.5": 0.25, "safe_reach_fraction": 0.25},
    "scene_conditioned_student_k4": {
        "collision_free_fraction": 0.25, "min_clearance_mean": 0.17572, "goal_dist_mean":
        0.176514, "goal_reach_fraction_0.5": 0.25, "safe_reach_fraction": 0.25},
    "canonical_scene_student": {
        "collision_free_fraction": 0.5, "min_clearance_mean": 0.240958, "goal_dist_mean":
        0.205037, "goal_reach_fraction_0.5": 0.5, "safe_reach_fraction": 0.5},
}


def gaps(making: dict, rows: dict) -> Dict[str, Dict[str, float]]:
    """|port - the yardstick's| of every bounded number: ``making`` holds the
    report's making numbers, ``rows`` the student's rows."""
    out = {"making": {}}
    for m in BOUNDS["making"]:
        if m == "first_losses":
            out["making"][m] = max(abs(a - b) for a, b in zip(making[m], MAKING[m]))
        else:
            out["making"][m] = abs(making[m] - MAKING[m])
    for row in ROWS:
        out[row] = {m: abs(rows[row][m] - METRICS[row][m]) for m in BOUNDS[row]}
    return out


def within(making: dict, rows: dict) -> bool:
    """Whether every gap lies within its bound."""
    return all(g <= BOUNDS[part][m] for part, gs in gaps(making, rows).items()
               for m, g in gs.items())
