"""The yardstick that the port of the panda arm's distillation recipe
(``scripts/distill_panda.py``) is held to: the JAX package on the CPU, its
numbers kept here as literals.

(a) The committed 3-eval student's closed loop (``COSTS``, ``PREFIX_COSTS``):
    ``artifacts/distilled_panda/student_3eval.pkl`` (``STUDENT``, times grid
    ``TIMES``) on the JAX script's evaluation protocol (its ``:92-107``):
    ``N_STEPS`` replans from ``x0()`` (0.3 rad on every joint of the shifted
    state, at rest), the context of ``make_panda_context``, the plant
    ``panda_rbd``, the statistics of ``data/panda_stats.py`` (the dataset's
    own), one key of ``jax.random.split(PRNGKey(7), 10)`` per episode,
    through the JAX package's ``make_closed_loop`` with the student's DDIM
    sampler (clip on) as ``sample_override``, jitted, seed by seed. Each
    episode's float32 stage costs summed in float64; ``PREFIX_COSTS`` over
    the first ``PREFIX_STEPS`` replans, the cut chip_smoke.py's phase 51 runs.
(b) The first distill steps from the teacher (``LOSSES``): the JAX
    package's ``make_distill_step`` (``make_optimizer(LR)``, round 0:
    ``teacher_cfg=True``, w = ``W``, teacher grid ``TEACHER_TIMES``, 12
    student pairs) from ``artifacts/flagship_panda_rbd/ema_params.pkl`` as
    teacher and student, on ``N_DISTILL_STEPS`` batches of ``BATCH`` rows of
    the teacher's ``dataset.npz`` (normalized with its own limits), the
    rows, each row's pair ``j`` and the noise from ``staged_draws`` (the JAX
    step's random calls replaced by substitutes that read them).

``tests/test_torch_port_distill_panda.py::test_yardstick_regenerates``
recomputes (a) and (b) (marked ``slow``).

(c) ``BOUNDS``, ``LOSS_BOUND``: how far the port may lie from (a) and (b),
    set on the CPU before the port's kernels ran on the card, from
    ``scripts/distill_panda_divergence.py``: (a)'s means over the 10
    episodes of the port's plain chain split (the episodes as one batch) on
    ``SEED_FAMILIES`` torch-seeded draws (``seeded_draws``; the JAX draws
    differ), each bound twice the largest gap; (b)'s steps of the port on
    the CPU on the same staged draws and from weights moved by one ulp,
    twice the largest relative gap.
(d) The paired gate (``PAIRED_PREFIX``, ``PAIRED_BOUND``): the port's plain
    chain split on the CPU over the first ``PREFIX_STEPS`` replans of the 10
    episodes on the draws seeded ``PAIRED_SEED_BASE + i``
    (``paired_prefix_costs``), and how far each episode on the card may lie
    from it: twice the largest gap that fp32-sized perturbations made
    (``scripts/distill_panda_divergence.py --paired``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["BATCH", "BOUNDS", "COSTS", "DATASET", "DRAW_SEED", "H", "KEY_SEED", "LOSSES",
           "LOSS_BOUND", "LR", "MEAN10", "N_DISTILL_STEPS", "N_SEEDS", "N_STEPS", "PAIRED_BOUND",
           "PAIRED_PREFIX", "PAIRED_SEED_BASE", "PREFIX_COSTS", "PREFIX_MEAN10", "PREFIX_STEPS",
           "SEED_FAMILIES", "STUDENT", "T", "TEACHER", "TEACHER_TIMES", "TIMES", "W", "gaps",
           "loss_gaps", "paired_gaps", "paired_prefix_costs", "paired_within", "staged_draws",
           "within", "x0"]

ARTIFACTS = Path(__file__).resolve().parents[2] / "artifacts"
STUDENT = ARTIFACTS / "distilled_panda" / "student_3eval.pkl"
TEACHER = ARTIFACTS / "flagship_panda_rbd" / "ema_params.pkl"
DATASET = ARTIFACTS / "flagship_panda_rbd" / "dataset.npz"
T, TIMES, H, N_SEEDS, N_STEPS, KEY_SEED, PREFIX_STEPS = 25, [23, 15, 7], 128, 10, 80, 7, 20
W, LR, BATCH, N_DISTILL_STEPS, DRAW_SEED = 0.01, 2e-4, 256, 5, 51
TEACHER_TIMES = list(range(23, -1, -1))  # ddim_time_grid(25, t_start=23)
N_PAIRS = 12
SEED_FAMILIES, PAIRED_SEED_BASE = 5, 51_000


def x0() -> np.ndarray:
    """The protocol's start: 0.3 rad on every joint of the shifted state, at rest."""
    return np.concatenate([np.full(7, 0.3), np.zeros(7)]).astype(np.float32)


def staged_draws(n_rows: int) -> Dict[str, np.ndarray]:
    """(b)'s draws from ``RandomState(DRAW_SEED)``: per step the batch's row indices into the
    dataset's ``n_rows``, then each row's pair ``j``, then the noise (BATCH, H, 7)."""
    rs = np.random.RandomState(DRAW_SEED)
    out = {"idx": [], "j": [], "noise": []}
    for _ in range(N_DISTILL_STEPS):
        out["idx"].append(rs.randint(0, n_rows, BATCH))
        out["j"].append(rs.randint(0, N_PAIRS, BATCH))
        out["noise"].append(rs.standard_normal((BATCH, H, 7)).astype(np.float32))
    return {k: np.stack(v) for k, v in out.items()}


COSTS = (
    244.92181766033173, 241.2422388792038, 247.70029997825623,
    243.6097787618637, 241.5911841392517, 244.9875864982605,
    248.79062676429749, 246.1142807006836, 253.1787165403366,
    241.63888609409332,)
PREFIX_COSTS = (
    39.20107662677765, 39.683719754219055, 58.004831075668335,
    49.5459018945694, 39.239238023757935, 48.80943250656128,
    47.99382042884827, 52.11269474029541, 61.65034759044647,
    39.18803322315216,)
LOSSES = (
    1.6742040315875784e-05, 0.00024303891404997557, 4.8613917897455394e-05,
    0.0001269892673008144, 0.00011885951971635222,)
MEAN10 = float(np.mean(COSTS))
PREFIX_MEAN10 = float(np.mean(PREFIX_COSTS))

# (c): twice the largest gap over scripts/distill_panda_divergence.py's runs on the CPU. The
# closed loop's 5 seed families (3 threads): the means of 10 episodes part from JAX's by up to
# 6.120662 (mean10) and 7.781497 (prefix, family 1) from one draw to the next. The losses (3
# threads): the port 1.116e-4 at most from JAX's (step 3), the one-ulp runs (seeds 100, 101) up
# to 1.337e-4 (seed 100's step 3) and 3.8e-5 from the unmoved run: the loss is a small
# difference (~1e-4) of reconstructions, so rounding moves it by ~1e-4 relative.
BOUNDS = {"mean10": 12.241324090957619, "prefix": 15.562994933128365}
LOSS_BOUND = 0.0002674570744117366


def gaps(costs=None, prefix_costs=None) -> Dict[str, float]:
    """|the mean of ``costs`` (one per episode) - MEAN10| under ``mean10``, and |the mean of
    ``prefix_costs`` - PREFIX_MEAN10| under ``prefix``, for those given."""
    out = {}
    if costs is not None:
        out["mean10"] = abs(float(np.mean(costs)) - MEAN10)
    if prefix_costs is not None:
        out["prefix"] = abs(float(np.mean(prefix_costs)) - PREFIX_MEAN10)
    return out


def within(costs=None, prefix_costs=None) -> bool:
    """Whether every gap lies within BOUNDS."""
    return all(g <= BOUNDS[k] for k, g in gaps(costs, prefix_costs).items())


def loss_gaps(losses: Sequence[float]) -> list:
    """Each step's |loss - LOSSES| relative to LOSSES."""
    return [abs(float(a) - b) / abs(b) for a, b in zip(losses, LOSSES, strict=True)]


# (d)
PAIRED_PREFIX = (
    49.48156702518463, 45.96254885196686, 39.04023456573486,
    46.012802481651306, 47.85542976856232, 39.11220121383667,
    54.592408657073975, 39.137144327163696, 84.3047741651535,
    39.10307419300079,)
# twice the largest gap over scripts/distill_panda_divergence.py --paired's fp32-sized
# perturbations (2 threads): x0 one ulp up 5.84e-5, every eps by a relative 1e-6 8.57e-5, every
# step's next state by a relative 1e-6 2.06e-4 (the largest). The bf16 entry's function lies
# 2.42e-3 to 0.363 from it (every episode outside: the control of phase 51), the next seed's
# draws 1.84 to 45.2; the clip off moves no episode (0.0): the student's reconstructions of these
# draws stay inside [-1, 1].
PAIRED_BOUND = 0.00041222572326660156


def paired_prefix_costs(dev) -> tuple:
    """Each paired episode's cost over its first PREFIX_STEPS replans through the port's chain
    split of the committed student on ``dev`` (the plain chain on the CPU): the 10 episodes as
    one batch, the draws seeded PAIRED_SEED_BASE + i (``scripts/distill_panda.py``'s
    ``seeded_draws``)."""
    from ..models import load_panda_student
    from ..scripts import distill_panda as dp
    from .panda_stats import panda_stats
    ins, cond = (st.to(dev) for st in panda_stats())
    loop, _ = dp.chain_loop(load_panda_student(STUDENT, device=dev), TIMES, N_SEEDS, PREFIX_STEPS,
                            H, dev, ins, cond)
    noise = dp.seeded_draws(range(PAIRED_SEED_BASE, PAIRED_SEED_BASE + N_SEEDS), PREFIX_STEPS,
                            H, dev)
    res = loop(torch.from_numpy(x0()).to(dev).expand(N_SEEDS, 14), noise)
    return tuple(float(c) for c in res.stage_costs.double().sum(-1).cpu())


def paired_gaps(prefix_costs) -> list:
    """|prefix_costs[i] - PAIRED_PREFIX[i]| for each of the 10 paired episodes."""
    return [abs(float(c) - p) for c, p in zip(prefix_costs, PAIRED_PREFIX, strict=True)]


def paired_within(prefix_costs) -> bool:
    """Whether every paired episode lies within PAIRED_BOUND of the port's plain episode."""
    return max(paired_gaps(prefix_costs)) <= PAIRED_BOUND
