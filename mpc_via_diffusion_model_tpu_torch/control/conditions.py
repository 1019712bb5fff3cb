"""State-to-condition maps that the episode kernels can run
(``state_to_condition`` of ``make_closed_loop`` and of the episode
makers). The JAX package passes a lambda there and traces it into its
kernel; CUDA cannot trace Python, so each map the CUDA episodes run is a
class here with its device counterpart in ``ops/csrc/plants.cuh``: ``kind``
names that counterpart (``ops/fused_episode.py::condition_kind``) and
``device_consts`` are the float32 numbers it reads from the episode's consts
table, as ``SafetyFirstCost`` carries its scorer's: ``ConcatFeatures``
here, and the panda arm's ``PandaContext`` (``dynamics/arm.py``, beside
the forward kinematics it runs). Any other callable still runs in
``make_closed_loop`` and in the episodes' plain versions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..dynamics.arm import PandaContext

__all__ = ["ConcatFeatures", "PandaContext"]


class ConcatFeatures:
    """``x (..., dx) -> cat([x, features], -1)``: the plant state followed by
    a block of constant features, e.g. a scene's 12 features for the
    scene-conditioned quadrotor student (the JAX package's ``lambda x:
    jnp.concatenate([x, feat])``). The features are moved to the state's
    device and broadcast over its leading axes."""

    kind = "concat_features"

    def __init__(self, features):
        self.features = torch.as_tensor(features, dtype=torch.float32).reshape(-1)

    @property
    def device_consts(self) -> Tuple[float, ...]:
        return tuple(float(v) for v in self.features.detach().cpu())

    def to(self, device) -> "ConcatFeatures":
        return ConcatFeatures(self.features.to(device))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        f = self.features.to(x.device)
        return torch.cat([x, f.expand(*x.shape[:-1], f.numel())], dim=-1)
