"""The yardstick that the scene-conditioned quadrotor student's serving
path is held to: the JAX package's ``scripts/bench_scene_student.py``
protocol on the CPU, as literals. The student
(``artifacts/scene_conditioned/scene_student_ema.pkl``, context 24, the
statistics of ``data/scene_stats.py``) flies ``N_STEPS`` replans through
held-out scene ``SCENE_INDEX`` of ``sample_scenes(SCENE_INDEX + 1,
seed=SCENE_SEED)`` from each of the ``N_STARTS`` starts
``eval_start_states(N_STARTS, seed=START_SEED)``, its context the state
followed by the scene's features, through the JAX package's XLA runtime loop
``make_closed_loop(..., state_to_condition=...)`` with the CFG DDPM sampler
(T = 25 + 5, w = 0.01), one key of ``jax.random.split(PRNGKey(KEY_SEED),
N_STARTS)`` per start, vmapped and jitted; the JAX episode kernel equals that
loop (``tests/test_fused_episode.py``):

- (a) ``k1``: K = 1, the task quadratic ``quadrotor_cost``;
- (b) ``k16``: K = 16, candidates scored by the scene's
  ``make_select_cost(quad_cost, centers, radii)``.

``METRICS[k]`` is ``track_metrics`` of each run's tracks against the scene;
``CLEARANCE_K*`` and ``GOAL_DIST_K*`` are each start's min clearance from the
scene's spheres and final distance to the goal.

- (c) ``BOUNDS[k]``: how far the port's metrics on the card may lie from
  ``METRICS[k]``, set on the CPU before the port ran on the card, from
  ``scripts/scene_divergence.py``: the port over the 16 starts with its own
  noise (torch seeds 0-7 at K = 1, 0-5 at K = 16; the card's runs draw from
  other seeds). Each bound is twice the largest gap of that metric from the
  yardstick over those runs, and a fraction's at least 2 of the 16 starts.

``tests/test_torch_port_scene.py::test_scene_yardstick_regenerates``
recomputes (a) and (b) with the JAX package (marked ``slow``: about 4
minutes on the CPU).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

__all__ = ["BOUNDS", "METRICS", "N_STARTS", "N_STEPS", "STUDENT", "T", "N_TAIL", "W",
           "SCENE_INDEX", "SCENE_SEED", "START_SEED", "KEY_SEED", "eval_starts", "gaps", "within"]

STUDENT = (Path(__file__).resolve().parents[2] / "artifacts" / "scene_conditioned"
           / "scene_student_ema.pkl")
T, N_TAIL, W = 25, 5, 0.01
SCENE_INDEX, SCENE_SEED, START_SEED, KEY_SEED, N_STARTS, N_STEPS = 0, 99, 11, 31, 16, 60

METRICS = {
    1: {"collision_free_fraction": 0.5625, "min_clearance_mean": 0.09615703672170639, "goal_dist_mean": 0.5495003461837769, "goal_reach_fraction_0.5": 0.5625, "safe_reach_fraction": 0.3125},
    16: {"collision_free_fraction": 1.0, "min_clearance_mean": 0.17216530442237854, "goal_dist_mean": 0.41309142112731934, "goal_reach_fraction_0.5": 0.625, "safe_reach_fraction": 0.625},
}

CLEARANCE_K1 = (-0.037074148654937744, 0.06838786602020264, -0.1262361705303192,
    -0.019300222396850586, 0.3371039032936096, 0.34177470207214355, 0.014187246561050415,
    -0.13451477885246277, 0.1898755431175232, -0.08395993709564209, 0.4229283332824707,
    0.14511382579803467, 0.13525134325027466, -0.025432586669921875, -0.1836913526058197,
    0.49409908056259155)
GOAL_DIST_K1 = (0.3377178907394409, 0.29255983233451843, 0.49446818232536316, 0.5959805250167847,
    0.25430670380592346, 0.42819955945014954, 0.6195748448371887, 0.5800675749778748,
    1.0150299072265625, 0.2188175767660141, 1.2552313804626465, 0.8180321455001831,
    0.2757006585597992, 0.7740669846534729, 0.3437771797180176, 0.48847469687461853)
CLEARANCE_K16 = (0.13374832272529602, 0.10896661877632141, 0.15913039445877075,
    0.05267810821533203, 0.24942362308502197, 0.3487231135368347, 0.14521420001983643,
    0.07239094376564026, 0.13125741481781006, 0.13086992502212524, 0.32295262813568115,
    0.1602635383605957, 0.18467137217521667, 0.06745576858520508, 0.07813665270805359,
    0.40876221656799316)
GOAL_DIST_K16 = (0.7929519414901733, 0.552273154258728, 0.36444711685180664, 0.26807036995887756,
    0.3354388177394867, 0.4264855682849884, 0.17717193067073822, 0.5466799736022949,
    0.4804873764514923, 0.12831969559192657, 0.5873996615409851, 0.3744441568851471,
    0.36963942646980286, 0.5290008783340454, 0.5579120516777039, 0.11874072998762131)

# (c): twice the largest gap over scripts/scene_divergence.py's runs (torch seeds 0-7 at K = 1,
# 0-5 at K = 16, the starts as they are: one ulp moved no start in the first K = 1 run, nor in
# the quadrotor's study), and
# for a fraction no less than 2 of the 16 starts. The largest gaps: K = 1 collision-free 0.1875
# (the port 0.625-0.75 over its 8 seeds against JAX's key draw at 0.5625), clearance 0.028649,
# goal distance 0.081468, reach 0.25, safe reach 0.1875; K = 16 collision-free 0.0625 (0.9375 in
# one run, 1.0 in the others), clearance 0.040136, goal distance 0.103757, reach and safe reach
# 0.1875.
BOUNDS = {
    1: {"collision_free_fraction": 0.375, "min_clearance_mean": 0.057298,
        "goal_dist_mean": 0.162937, "goal_reach_fraction_0.5": 0.5,
        "safe_reach_fraction": 0.375},
    16: {"collision_free_fraction": 0.125, "min_clearance_mean": 0.080272,
         "goal_dist_mean": 0.207515, "goal_reach_fraction_0.5": 0.375,
         "safe_reach_fraction": 0.375},
}


def eval_starts() -> np.ndarray:
    """The protocol's starts, (N_STARTS, 12) float32."""
    from ..scripts.quadrotor_task import eval_start_states
    return eval_start_states(N_STARTS, seed=START_SEED)


def gaps(metrics: Dict[str, float], k: int) -> Dict[str, float]:
    """|metric - the yardstick's| for every metric that BOUNDS[k] names."""
    return {m: abs(metrics[m] - METRICS[k][m]) for m in BOUNDS[k]}


def within(metrics: Dict[str, float], k: int) -> bool:
    """Whether every gap of ``metrics`` from METRICS[k] lies within BOUNDS[k]."""
    return all(g <= BOUNDS[k][m] for m, g in gaps(metrics, k).items())
