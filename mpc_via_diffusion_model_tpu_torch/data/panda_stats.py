"""Normalizer statistics of the panda arm flagship's dataset,
``artifacts/flagship_panda_rbd/dataset.npz`` (4,320 samples of 128-step
horizons of the 7 joint torques, conditioned on the 20-dim context of
``dynamics/arm.py::make_panda_context``): the limits of its ``inputs`` and
``condition``, which the on-policy panda student normalizes with (the JAX
package's ``scripts/bench_panda_student.py`` reads them with
``ds.normalizer.stats``).

The chip copy of the repository leaves the 14.9 MB dataset out, so the port
reads these numbers. Each literal below is the float32 value of the JAX
package's ``ControlSequenceDataset.load(...).normalizer.stats`` on that
file, exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .normalization import NormalizerStats

__all__ = ["panda_stats"]

INPUTS_MINS = (-11.231573104858398, -26.62944221496582, -26.236440658569336, -20.79653549194336,
               -3.6765737533569336, -5.29660701751709, -1.003687858581543)
INPUTS_MAXS = (17.290264129638672, 37.482852935791016, 30.492198944091797, 38.30565643310547,
               4.049101829528809, 5.6886701583862305, 0.9705134034156799)
CONDITION_MINS = (-0.703988790512085, -1.5004466772079468, -0.7231165170669556,
                  -3.192270517349243, -0.6490439176559448, 0.824859619140625,
                  0.06548982858657837, -0.9255071878433228, -0.9647967219352722,
                  -0.9772586822509766, -3.087394952774048, -1.3168585300445557,
                  -1.5642404556274414, -1.2961523532867432, -0.10778707265853882,
                  -0.3461494743824005, 0.21735891699790955, -1.1429730653762817,
                  -0.631020724773407, -1.5001014471054077)
CONDITION_MAXS = (0.7112871408462524, -0.14051342010498047, 0.747118353843689,
                  -1.6043024063110352, 0.752784013748169, 2.1673476696014404,
                  1.525159478187561, 1.0501080751419067, 1.3063321113586426,
                  0.8929181098937988, 1.8886207342147827, 1.1685519218444824,
                  0.9939020872116089, 1.4702320098876953, 0.49713730812072754,
                  0.34546804428100586, 0.9290691018104553, 0.5649243593215942,
                  0.49969321489334106, 0.7199490666389465)


def panda_stats() -> Tuple[NormalizerStats, NormalizerStats]:
    """(inputs_stats, condition_stats), limits normalizers on the CPU."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    return (NormalizerStats("limits", f32(INPUTS_MINS), f32(INPUTS_MAXS)),
            NormalizerStats("limits", f32(CONDITION_MINS), f32(CONDITION_MAXS)))
