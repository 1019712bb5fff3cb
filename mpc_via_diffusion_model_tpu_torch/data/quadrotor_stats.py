"""Normalizer statistics of the quadrotor flagship's dataset,
``artifacts/flagship_quadrotor/dataset.npz`` (19,200 samples of 48-step
horizons of the 4 controls, conditioned on the 12-state): the limits of its
``inputs`` and ``condition``, which the quadrotor student normalizes with
(``scripts/bench_quadrotor_student.py`` of the JAX package reads them with
``ds.normalizer.stats``).

The chip copy of the repository leaves the 14.6 MB dataset out, so the port
reads these numbers. Each literal below is the float32 value of the JAX
package's ``ControlSequenceDataset.load(...).normalizer.stats`` on that
file, exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .normalization import NormalizerStats

__all__ = ["quadrotor_stats"]

INPUTS_MINS = (-17.443090438842773, -4.54302453994751, -4.80381441116333, -5.085553169250488)
INPUTS_MAXS = (45.1805419921875, 5.021545886993408, 4.051145553588867, 5.286790370941162)
CONDITION_MINS = (-0.05499757081270218, -1.289048433303833, -0.10298380255699158,
                  -4.432196617126465, -1.9919744729995728, -2.2012975215911865,
                  -0.9504912495613098, -1.4056988954544067, -0.8418644070625305,
                  -7.319244861602783, -10.028448104858398, -5.039784908294678)
CONDITION_MAXS = (3.118075132369995, 1.280343770980835, 1.4691191911697388,
                  0.16629424691200256, 1.8791557550430298, 0.4712321162223816,
                  0.8412965536117554, 0.8182646632194519, 0.7290881872177124,
                  9.553915977478027, 11.546609878540039, 5.457058429718018)


def quadrotor_stats() -> Tuple[NormalizerStats, NormalizerStats]:
    """(inputs_stats, condition_stats), limits normalizers on the CPU."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    return (NormalizerStats("limits", f32(INPUTS_MINS), f32(INPUTS_MAXS)),
            NormalizerStats("limits", f32(CONDITION_MINS), f32(CONDITION_MAXS)))
