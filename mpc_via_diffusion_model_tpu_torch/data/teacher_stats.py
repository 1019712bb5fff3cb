"""Normalizer statistics of the distilled cart-pole students' teacher,
``artifacts/flagship_modality``: the limits of its dataset's ``inputs``
(controls) and ``condition`` (the 5 plant states), which the students
normalize with (``scripts/onpolicy_cartpole.py`` and
``scripts/bench_deep_students.py`` load that dataset for them).

The dataset is git-ignored; its collection is seeded and regenerates these
numbers. They were made by

    JAX_PLATFORMS=cpu python scripts/flagship_modality.py --cpu --collect-only \\
        --grid-pos 5 --grid-theta 21 --steps 80 --noisy 10 \\
        --out build/flagship_modality_collect

(184,800 samples, as ``artifacts/flagship_modality/report.json`` records)
and read from ``ControlSequenceDataset.load(...).normalizer.stats`` of the
JAX package: each literal below is that float32 value, exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .normalization import NormalizerStats

__all__ = ["teacher_stats"]

INPUTS_MINS = (-3388.220947265625,)
INPUTS_MAXS = (3373.41796875,)
CONDITION_MINS = (-35.03929138183594, -84.66761016845703, -0.6844568848609924,
                  -8.886580467224121, -0.8280881643295288)
CONDITION_MAXS = (35.21458053588867, 84.49385833740234, 7.031763553619385,
                  8.91261100769043, 3.6672000885009766)


def teacher_stats() -> Tuple[NormalizerStats, NormalizerStats]:
    """(inputs_stats, condition_stats), limits normalizers on the CPU."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    return (NormalizerStats("limits", f32(INPUTS_MINS), f32(INPUTS_MAXS)),
            NormalizerStats("limits", f32(CONDITION_MINS), f32(CONDITION_MAXS)))
