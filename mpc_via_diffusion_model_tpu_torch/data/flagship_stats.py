"""Normalizer statistics of the flagship's dataset, ``artifacts/flagship``:
the limits of its ``inputs`` (controls) and ``condition`` (the 5 plant
states), which the flagship normalizes with (``scripts/flagship_run.py``
evaluates it with ``ds.normalizer.stats``).

The dataset is git-ignored; its collection is seeded and regenerates these
numbers. They were made by

    JAX_PLATFORMS=cpu python scripts/flagship_run.py --cpu --collect-only \\
        --grid-pos 10 --grid-theta 20 --steps 80 --noisy 10 \\
        --out build/flagship_collect

(352,000 samples, as ``artifacts/flagship/report.json`` records; never with
``--out artifacts/flagship``, where the script would overwrite the tracked
``args.yaml``) and read from ``ControlSequenceDataset.load(...).normalizer.stats``
of the JAX package: each literal below is that float32 value, exactly. A
collection on the CPU is not promised to be bit-equal to the TPU's that the
flagship was trained on.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .normalization import NormalizerStats

__all__ = ["flagship_stats"]

INPUTS_MINS = (-25.460765838623047,)
INPUTS_MAXS = (25.59148406982422,)
CONDITION_MINS = (-2.172290563583374, -1.9672412872314453, 1.5044246912002563,
                  -1.4098364114761353, 2.173607587814331)
CONDITION_MAXS = (1.9615428447723389, 1.9054303169250488, 4.817324638366699,
                  1.442134141921997, 3.796726942062378)


def flagship_stats() -> Tuple[NormalizerStats, NormalizerStats]:
    """(inputs_stats, condition_stats), limits normalizers on the CPU."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    return (NormalizerStats("limits", f32(INPUTS_MINS), f32(INPUTS_MAXS)),
            NormalizerStats("limits", f32(CONDITION_MINS), f32(CONDITION_MAXS)))
