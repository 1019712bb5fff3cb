"""Normalizer statistics of the scene-conditioned quadrotor student
(``artifacts/scene_conditioned/scene_student_ema.pkl``, context 24): the
inputs' limits and the 24-dim condition limits, built as the JAX package's
``scripts/bench_scene_student.py`` builds them (and its training script,
``scripts/scene_conditioned_quadrotor.py``):

- the condition's first 12 limits are the teacher's dataset's, the
  12-state's (``data/quadrotor_stats.py``);
- its last 12 are ``fit_normalizer``'s limits of the scene features of the
  seeded draw ``sample_scenes(50_000, seed=123)``, the scenes' sampling
  distribution, computed here from that draw (numpy, bit-equal to the JAX
  task's), not read from a dataset;
- the inputs' limits are the teacher's dataset's.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from .normalization import NormalizerStats, fit_normalizer
from .quadrotor_stats import quadrotor_stats

__all__ = ["SCENE_DRAWS", "SCENE_SEED", "scene_feature_stats", "scene_stats"]

SCENE_DRAWS, SCENE_SEED = 50_000, 123


@functools.lru_cache(maxsize=None)
def _feature_limits() -> Tuple[torch.Tensor, torch.Tensor]:
    from ..scripts.quadrotor_task import sample_scenes, scene_features
    st = fit_normalizer(scene_features(*sample_scenes(SCENE_DRAWS, seed=SCENE_SEED)).numpy())
    return st.mins, st.maxs


def scene_feature_stats() -> NormalizerStats:
    """The limits of the 12 scene features over the seeded draw."""
    mins, maxs = _feature_limits()
    return NormalizerStats("limits", mins.clone(), maxs.clone())


def scene_stats() -> Tuple[NormalizerStats, NormalizerStats]:
    """(inputs_stats, condition_stats) of the scene student, limits
    normalizers on the CPU: the condition's are the 12-state's then the
    scene features'."""
    ins, cond = quadrotor_stats()
    feat = scene_feature_stats()
    return ins, NormalizerStats("limits", torch.cat([cond.mins, feat.mins]),
                                torch.cat([cond.maxs, feat.maxs]))
