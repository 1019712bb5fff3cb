"""Normalizer statistics of the LMPC parity workload's dataset, the one the
committed weights ``artifacts/flagship_lmpc/ema_params.pkl`` were trained on:
the limits of its ``inputs`` (the LQR expert's horizon-8 controls) and
``condition`` (the 4 states of the linear cart-pole).

The dataset is git-ignored; its collection is seeded and regenerates these
numbers by the recipe of ``scripts/flagship_lmpc.py`` as it stood when the
weights were committed (commit a33ca98, lines 75-116), with the JAX
package's ``cartpole_lmpc`` and ``cartpole_lmpc_cost``:

1. the 15 x 15 grid of (position, angle) over [-1, 1] x [-pi/4, pi/4],
   velocities 0, through ``collect_lmpc_dataset`` at horizon 8 with
   ``noise_std`` 0.15, ``n_noisy`` 399 and ``PRNGKey(0)`` (90,000 samples);
2. the LQR expert's 50-step closed-loop tracks from every grid state, each
   step ``lqr_solve`` without precomputed gains (11,250 states and their
   horizons);
3. 4 noisy replicas of those states,
   ``np.random.RandomState(1).normal(0, 0.15, (4,) + x_cl.shape)``, each
   solved by ``lqr_solve`` (45,000);
4. the arrays concatenated as grid, tracks, replicas and fitted by
   ``ControlSequenceDataset.from_arrays`` (146,250 samples, as
   ``artifacts/flagship_lmpc/report.json`` records).

Each literal is that float32 value, exactly
(``tests/test_torch_port_lmpc.py`` regenerates them). The script's current
recipe (the replicas drawn by ``collect_lmpc_dataset`` from ``PRNGKey(1)``,
the tracks solved with precomputed gains) gives the same input limits but
other condition limits, and the closed loop on the committed weights is
very sensitive to them: over the 16 sweep states below the JAX loop's mean
u_l1 is 2.5538 with the current recipe's limits against 0.0830 with these.

``LMPC_U_L1`` is the yardstick the port's parity run is held to: the JAX
package's closed loop of ``scripts/flagship_lmpc.py``'s step 3 (plain
``make_closed_loop``, one sample, 50 steps, T = 25 + 5, w = 0.01) on these
statistics and the committed weights, on the CPU, with keys
``fold_in(PRNGKey(7), i)``: sum |u_diffusion - u_lqr| of each of the 16
sweep states (``RandomState(30)``; ``scripts/lmpc_parity.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .normalization import NormalizerStats

__all__ = ["lmpc_stats", "LMPC_U_L1", "LMPC_U_L1_SUMMARY"]

INPUTS_MINS = (-19.453567504882812,)
INPUTS_MAXS = (20.541444778442383,)
CONDITION_MINS = (-2.1100337505340576, -3.011676549911499, -1.3717907667160034,
                  -4.532594680786133)
CONDITION_MAXS = (2.08001971244812, 3.0822370052337646, 1.3032593727111816, 4.674459457397461)

LMPC_U_L1 = (0.024410871788859367, 0.04330282285809517, 0.11293777823448181,
             0.035601768642663956, 0.13563179969787598, 0.06903717666864395,
             0.0464344397187233, 0.061905551701784134, 0.09579992294311523,
             0.06474398076534271, 0.09395831823348999, 0.13099631667137146,
             0.042815934866666794, 0.10025510936975479, 0.09985658526420593,
             0.169484943151474)
# the same run's mean, median, best and worst
LMPC_U_L1_SUMMARY = (0.08294833253603429, 0.08149774745106697, 0.024410871788859367,
                     0.169484943151474)


def lmpc_stats() -> Tuple[NormalizerStats, NormalizerStats]:
    """(inputs_stats, condition_stats), limits normalizers on the CPU."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    return (NormalizerStats("limits", f32(INPUTS_MINS), f32(INPUTS_MAXS)),
            NormalizerStats("limits", f32(CONDITION_MINS), f32(CONDITION_MAXS)))
