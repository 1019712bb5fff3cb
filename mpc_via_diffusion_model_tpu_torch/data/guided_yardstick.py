"""The yardstick that the guided quadrotor rows are held to: the JAX
package's protocols on the CPU (XLA loops, vmapped and jitted), as literals.
The quadrotor flagship's teacher (``TEACHER``: horizon 48, 4 controls,
context 12, the statistics of ``data/quadrotor_stats.py``) flies ``N_STEPS``
replans from each of ``N_STARTS`` starts through the JAX package's
``make_closed_loop`` with the CFG DDPM sampler (T = 25 + 5, w = 0.01):

- (a) the flagship's table (``scripts/flagship_quadrotor.py:199-223``): the
  starts ``eval_start_states(N_STARTS)`` (seed ``FLAGSHIP_START_SEED``),
  the keys ``jax.random.split(PRNGKey(FLAGSHIP_KEY_SEED), N_STARTS)``, the
  loop's cost ``make_task_cost(quad_cost)``; ``guided`` with the canonical
  scene's ``make_loop_guide_builder(plant, in_stats, GUIDE_SCALE)`` at
  ``t_start_guide`` ``T_START_FLAGSHIP`` (T / 2), and ``unguided``.
  ``METRICS`` holds ``track_metrics`` with ``cost_mean``.
- (b) the scene study's held-out evaluation
  (``scripts/scene_conditioned_quadrotor.py:278-330``), its first 16
  (scene, start) pairs: scene 0 of ``sample_scenes(N_SCENES,
  seed=SCENE_SEED)`` (not of ``sample_scenes(1, ...)``: the draws depend
  on n), the starts ``eval_start_states(N_STARTS, seed=SCENE_START_SEED)``,
  the keys ``jax.random.split(PRNGKey(SCENE_KEY_SEED), N_SCENES *
  N_STARTS)[:N_STARTS]``, the loop's cost ``quad_cost``, vmapped over the
  pairs as the study vmaps them; ``oracle`` with the scene's per-row guide
  (``make_penalty_grad(..., scene_args=True)``) at ``T_START_SCENE``, and
  ``blind``. ``METRICS`` holds ``track_metrics`` against the scene.

``CLEARANCE_*`` and ``GOAL_DIST_*`` are each start's min clearance from its
scene's spheres and final distance to the goal.

- (c) ``BOUNDS[row]``: how far the port's metrics on the card may lie from
  ``METRICS[row]``, set on the CPU before the port ran on the card, from
  ``scripts/guided_divergence.py``: the port over the same starts with its
  own torch-seeded noise, the starts as they are and moved by one ulp. Each
  bound is twice the largest gap of that metric over those runs, and a
  fraction's at least 2 of the 16 starts.

``tests/test_torch_port_guidance.py::test_guided_yardstick_regenerates``
recomputes (a) and (b) with the JAX package (marked ``slow``: about 2.5
minutes on the CPU).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

__all__ = ["BOUNDS", "METRICS", "ROWS", "TEACHER", "T", "N_TAIL", "W", "GUIDE_SCALE",
           "T_START_FLAGSHIP", "T_START_SCENE", "N_STARTS", "N_STEPS", "N_SCENES",
           "FLAGSHIP_START_SEED", "FLAGSHIP_KEY_SEED", "SCENE_SEED", "SCENE_START_SEED",
           "SCENE_KEY_SEED", "PAIRS", "RAISE_MIN", "PAIRED", "PAIRED_BOUNDS", "gaps", "within",
           "paired", "paired_gaps", "paired_within"]

TEACHER = (Path(__file__).resolve().parents[2] / "artifacts" / "flagship_quadrotor"
           / "ema_params.pkl")
T, N_TAIL, W, GUIDE_SCALE = 25, 5, 0.01, 0.1
T_START_FLAGSHIP, T_START_SCENE = T / 2, 6.25
N_STARTS, N_STEPS, N_SCENES = 16, 60, 8
FLAGSHIP_START_SEED, FLAGSHIP_KEY_SEED = 7, 11
SCENE_SEED, SCENE_START_SEED, SCENE_KEY_SEED = 99, 11, 31
ROWS = ("guided", "unguided", "oracle", "blind")

METRICS = {
    "guided": {"collision_free_fraction": 0.9375, "min_clearance_mean": 0.11402857303619385,
        "goal_dist_mean": 0.5856857895851135, "goal_reach_fraction_0.5": 0.4375,
        "safe_reach_fraction": 0.4375, "cost_mean": 3146.750732421875},
    "unguided": {"collision_free_fraction": 0.625, "min_clearance_mean": 0.05291146785020828,
        "goal_dist_mean": 0.5611660480499268, "goal_reach_fraction_0.5": 0.5625,
        "safe_reach_fraction": 0.5, "cost_mean": 3153.0244140625},
    "oracle": {"collision_free_fraction": 0.875, "min_clearance_mean": 0.07562461495399475,
        "goal_dist_mean": 0.5711034536361694, "goal_reach_fraction_0.5": 0.375,
        "safe_reach_fraction": 0.375},
    "blind": {"collision_free_fraction": 0.5, "min_clearance_mean": 0.00509025901556015,
        "goal_dist_mean": 0.4833030104637146, "goal_reach_fraction_0.5": 0.4375,
        "safe_reach_fraction": 0.125},
}

CLEARANCE_GUIDED = (0.12478011846542358, 0.0020287930965423584, 0.4032791256904602,
    0.05015617609024048, 0.08755648136138916, 0.2873924970626831, 0.025650322437286377,
    0.10246771574020386, 0.158575177192688, 0.26333433389663696, 0.010025590658187866,
    0.09564083814620972, 0.03816869854927063, -0.0077492594718933105, 0.16002976894378662,
    0.023120760917663574)
GOAL_DIST_GUIDED = (0.27539390325546265, 0.595215916633606, 0.5524286031723022,
    0.45951876044273376, 0.8439720273017883, 0.4926161468029022, 0.45071321725845337,
    0.6451181173324585, 0.3592311441898346, 0.410966157913208, 0.7183625102043152,
    1.2982701063156128, 0.12596085667610168, 0.8582615256309509, 0.511102020740509,
    0.7738420963287354)
CLEARANCE_UNGUIDED = (0.10798639059066772, -0.13206875324249268, 0.3451979160308838,
    0.05837053060531616, -0.01182413101196289, 0.287392258644104, -0.03413110971450806,
    0.08393645286560059, 0.1585707664489746, 0.24507898092269897, -0.13102740049362183,
    0.0960586667060852, 0.026566684246063232, -0.2590309977531433, 0.12459123134613037,
    -0.11908400058746338)
GOAL_DIST_UNGUIDED = (0.2889755666255951, 1.0189921855926514, 0.3652493357658386,
    0.3024391531944275, 0.7486148476600647, 0.4926186800003052, 0.40284252166748047,
    0.7604582905769348, 0.3706555962562561, 0.4225839376449585, 0.5259615778923035,
    1.284213662147522, 0.17068146169185638, 0.8799307942390442, 0.44373348355293274,
    0.5007053017616272)
CLEARANCE_ORACLE = (0.002113044261932373, 0.019286662340164185, 0.15462547540664673,
    -0.010142505168914795, 0.07744374871253967, 0.06691738963127136, 0.27485865354537964,
    0.12152683734893799, 0.025706082582473755, 0.06339097023010254, 0.18319159746170044,
    0.015787124633789062, -0.016362875699996948, 0.054707109928131104, 0.051460057497024536,
    0.1254844069480896)
GOAL_DIST_ORACLE = (1.1800357103347778, 0.6607558131217957, 0.4055526554584503,
    0.6034705638885498, 0.3720763921737671, 0.47801297903060913, 0.4613938629627228,
    0.587486982345581, 0.6119447946548462, 0.5523722767829895, 0.5662899613380432,
    0.8718209862709045, 0.5553752183914185, 0.6767176985740662, 0.24386830627918243,
    0.3104809820652008)
CLEARANCE_BLIND = (-0.19019079208374023, -0.03161591291427612, 0.11116743087768555,
    -0.13060688972473145, -0.06432825326919556, 0.024303466081619263, 0.2624187469482422,
    0.06818234920501709, -0.006386607885360718, 0.0515216588973999, 0.17121702432632446,
    -0.09144723415374756, -0.1591149866580963, 0.05470705032348633, -0.009628534317016602,
    0.021245628595352173)
GOAL_DIST_BLIND = (0.5018641352653503, 0.24944907426834106, 0.6352131366729736,
    0.36748263239860535, 0.16162651777267456, 0.5308094620704651, 0.49128860235214233,
    0.6411954164505005, 0.6334748268127441, 0.31967705488204956, 0.5428255796432495,
    0.8221086263656616, 0.33022841811180115, 0.6767393350601196, 0.15561605989933014,
    0.6732493042945862)

# (c): twice the largest gap over scripts/guided_divergence.py's runs (torch seeds 0-4, the
# starts as they are, and seed 0 with the starts moved one ulp up and down), and for a fraction
# no less than 2 of the 16 starts. The largest gaps (collision-free, clearance, goal distance,
# reach, safe reach, cost):
#   guided: 0.1875, 0.056169, 0.104168, 0.25, 0.25, 55.697;
#   unguided: 0.1875, 0.075528, 0.117744, 0.25, 0.3125, 52.558;
#   oracle: 0.3125, 0.016158, 0.090035, 0.1875, 0.125;
#   blind: 0.125, 0.029226, 0.158604, 0.375, 0.375.
# One ulp moved the guided row's collision-free fraction (0.9375 -> 1.0 at seed 0), the guided
# and oracle rows' clearance and goal distance by up to 0.009, and no unguided row's fraction.
BOUNDS = {
    "guided": {"collision_free_fraction": 0.375, "min_clearance_mean": 0.112337,
        "goal_dist_mean": 0.208336, "goal_reach_fraction_0.5": 0.5, "safe_reach_fraction": 0.5,
        "cost_mean": 111.394531},
    "unguided": {"collision_free_fraction": 0.375, "min_clearance_mean": 0.151056,
        "goal_dist_mean": 0.235488, "goal_reach_fraction_0.5": 0.5, "safe_reach_fraction": 0.625,
        "cost_mean": 105.116211},
    "oracle": {"collision_free_fraction": 0.625, "min_clearance_mean": 0.032316,
        "goal_dist_mean": 0.180069, "goal_reach_fraction_0.5": 0.375, "safe_reach_fraction": 0.25},
    "blind": {"collision_free_fraction": 0.25, "min_clearance_mean": 0.058452,
        "goal_dist_mean": 0.317208, "goal_reach_fraction_0.5": 0.75, "safe_reach_fraction": 0.75},
}

# (d) The paired gates, each over two rows on the same starts and the same noise: each start's
# gain in min clearance, guided minus unguided, as the per-start mean (gain_mean) and the count of
# starts whose clearance the guide raised by more than RAISE_MIN (n_raised; a start whose min
# clearance is its first state's gains nothing but rounding). "flagship" pairs the flagship's
# guided and unguided rows, "scene0" the scene-0 oracle and blind rows, over their 60 replans
# (PAIRS; the JAX package's values from the CLEARANCE_* literals). "heldout_first_plans" pairs the
# oracle's and the blind teacher's first plans over all N_SCENES x N_STARTS pairs of the scene
# study's held-out protocol, each rolled open-loop from its start and scored against its own
# scene: the one replan a chip run can afford (a guided replan costs ~2 s there, PERF.md),
# where the 60-replan rows cost minutes. PAIRED holds the JAX package's values; PAIRED_BOUNDS
# twice the largest gap over scripts/guided_divergence.py's paired runs (torch seeds 0-4 and
# seed 0's one-ulp starts; --first-plans --seeds 16 for the held-out pairs), the count's at least
# 2. A guide that returns zeros gains nothing and lies outside every one of them.
PAIRS = {"flagship": ("guided", "unguided"), "scene0": ("oracle", "blind")}
RAISE_MIN = 1e-3


def paired(clear_guided, clear_unguided) -> Dict[str, float]:
    """The paired gate's statistics of two rows' per-start min clearances."""
    gain = np.asarray(clear_guided, np.float64) - np.asarray(clear_unguided, np.float64)
    return {"gain_mean": float(gain.mean()), "n_raised": int((gain > RAISE_MIN).sum())}


PAIRED: Dict[str, Dict[str, float]] = {
    # paired() of the CLEARANCE_* literals of each pair's rows
    "flagship": {"gain_mean": 0.061117103323340416, "n_raised": 12},
    "scene0": {"gain_mean": 0.0705343522131443, "n_raised": 15},
    # the JAX package's first replans (the keys split(PRNGKey(SCENE_KEY_SEED), 128), each
    # start's first replan key the first of its split into N_STEPS)
    "heldout_first_plans": {"gain_mean": 0.20541866752319038, "n_raised": 35},
}
# The largest gaps (gain_mean, n_raised) over the runs: flagship 0.027672, 4 (the JAX package's
# 0.061117, 12); scene0 0.018910, 3 (0.070534, 15); heldout_first_plans, over torch seeds 0-15
# (seeds 0-4 alone spread 0.022035, 2: too few for a count over 128 pairs), 0.054988, 9
# (0.205419, 35). So a zero guide (0, 0) lies outside all three, by both statistics.
PAIRED_BOUNDS: Dict[str, Dict[str, float]] = {
    "flagship": {"gain_mean": 0.055345, "n_raised": 8},
    "scene0": {"gain_mean": 0.037821, "n_raised": 6},
    "heldout_first_plans": {"gain_mean": 0.109977, "n_raised": 18},
}


def paired_gaps(stats: Dict[str, float], gate: str) -> Dict[str, float]:
    """|statistic - the JAX package's| of a paired gate."""
    return {m: abs(stats[m] - PAIRED[gate][m]) for m in PAIRED[gate]}


def paired_within(stats: Dict[str, float], gate: str) -> bool:
    """Whether a paired gate's statistics lie within PAIRED_BOUNDS of the JAX package's."""
    return all(g <= PAIRED_BOUNDS[gate][m] for m, g in paired_gaps(stats, gate).items())


def gaps(metrics: Dict[str, float], row: str) -> Dict[str, float]:
    """|metric - the yardstick's| for every metric that BOUNDS[row] names."""
    return {m: abs(metrics[m] - METRICS[row][m]) for m in BOUNDS[row]}


def within(metrics: Dict[str, float], row: str) -> bool:
    """Whether every gap of ``metrics`` from METRICS[row] lies within BOUNDS[row]."""
    return all(g <= BOUNDS[row][m] for m, g in gaps(metrics, row).items())
