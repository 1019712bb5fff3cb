"""In-memory control-sequence datasets: port of
``mpc_via_diffusion_model_tpu/data/datasets.py`` (``ControlSequenceDataset``,
``train_val_split``, ``specified_split``).

Fields ``inputs`` (N, H, du), the expert's control horizons, and
``condition`` (N, dx), the states they were solved from; a normalizer
fitted per field over the flattened data, and the normalized copies beside
them, all on the device. Minibatches are drawn i.i.d. with replacement, by
an index gather on the device. ``.npz`` files hold the JAX package's keys
(``inputs``, ``condition``); its ``.css`` store and ``load_reference_pt``
wait for the port of ``native/`` (ROADMAP.md A8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .normalization import DatasetNormalizer, canonical_kind, normalize, unnormalize

__all__ = ["ControlSequenceDataset", "specified_split", "train_val_split"]

FIELD_INPUTS = "inputs"
FIELD_CONDITION = "condition"


@dataclasses.dataclass(frozen=True)
class ControlSequenceDataset:
    """(inputs, condition) pairs and their fitted normalizer; the arrays on
    one device, the normalizer's statistics on the CPU."""

    inputs: torch.Tensor                # (N, H, du)
    condition: torch.Tensor             # (N, dx)
    inputs_normalized: torch.Tensor
    condition_normalized: torch.Tensor
    normalizer: DatasetNormalizer
    # the share of expert solves whose last iLQR backward pass was PD (set by
    # ``collect_closed_loop_dataset``; None for datasets made otherwise)
    solver_converged_fraction: Optional[float] = None

    @classmethod
    def from_arrays(cls, inputs, condition, normalizer: str = "LimitsNormalizer",
                    device=None) -> "ControlSequenceDataset":
        """Fits the normalizer on the float32 arrays, as the JAX package
        does, and keeps them and their normalized copies on ``device``
        (``cuda`` unless given)."""
        dev = resolve_device(device)
        to_np = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                           else np.asarray(a)).astype(np.float32)
        inputs, condition = to_np(inputs), to_np(condition)
        if not (inputs.ndim == 3 and condition.ndim == 2 and inputs.shape[0] == condition.shape[0]):
            raise ValueError(f"inputs (N, H, du) and condition (N, dx), got {inputs.shape} and "
                             f"{condition.shape}")
        dn = DatasetNormalizer.fit({FIELD_INPUTS: inputs, FIELD_CONDITION: condition},
                                   kind=canonical_kind(normalizer))
        ins, cond = torch.from_numpy(inputs).to(dev), torch.from_numpy(condition).to(dev)
        return cls(ins, cond, normalize(dn.stats[FIELD_INPUTS].to(dev), ins),
                   normalize(dn.stats[FIELD_CONDITION].to(dev), cond), dn)

    @classmethod
    def load(cls, path: str, normalizer: str = "LimitsNormalizer",
             device=None) -> "ControlSequenceDataset":
        """From an ``.npz`` file with the keys ``inputs`` and ``condition``."""
        if not str(path).endswith(".npz"):
            raise ValueError(f"unsupported dataset path: {path} (expected .npz; the .css store "
                             f"waits for the port of native/)")
        with np.load(path) as z:
            return cls.from_arrays(z["inputs"], z["condition"], normalizer, device)

    def save(self, path: str) -> None:
        np.savez_compressed(path, inputs=self.inputs.cpu().numpy(),
                            condition=self.condition.cpu().numpy())

    @property
    def device(self) -> torch.device:
        return self.inputs.device

    @property
    def n_init(self) -> int:
        return int(self.inputs.shape[0])

    @property
    def n_support_points(self) -> int:
        return int(self.inputs.shape[1])

    @property
    def state_dim(self) -> int:
        """The channel count of the diffused tensor (the controls), named as
        the reference names it."""
        return int(self.inputs.shape[2])

    @property
    def condition_dim(self) -> int:
        return int(self.condition.shape[1])

    def __len__(self) -> int:
        return self.n_init

    def _stats(self, field: str):
        return self.normalizer.stats[field].to(self.device)

    def normalize_condition(self, x0: torch.Tensor) -> torch.Tensor:
        return normalize(self._stats(FIELD_CONDITION), x0)

    def unnormalize_states(self, u_norm: torch.Tensor) -> torch.Tensor:
        """Unnormalizes sampled inputs (clipped to the limits first)."""
        return unnormalize(self._stats(FIELD_INPUTS), u_norm)

    def batch(self, generator: Optional[torch.Generator],
              batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A minibatch of (inputs_normalized, condition_normalized), drawn
        i.i.d. with replacement from ``generator`` on the data's device."""
        idx = torch.randint(0, self.n_init, (batch_size,), generator=generator, device=self.device)
        return self.inputs_normalized[idx], self.condition_normalized[idx]


def train_val_split(n: int, val_fraction: float = 0.05,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A random index split (the reference's random_split(0.95/0.05)), drawn
    by numpy's ``RandomState(seed)`` as the JAX package draws it."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_val = max(1, int(round(n * val_fraction)))
    return perm[n_val:], perm[:n_val]


def specified_split(normal_pos_range, normal_neg_range, noisy_pos_range, noisy_neg_range,
                    val_fraction: float = 0.05) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's interleaved split: the first (1 - val_fraction) of
    each range goes to training, the tail to validation, the positive and
    negative ranges interleaved pairwise. Paired ranges must have equal
    lengths. Returns (train_indices, val_indices), int64 numpy."""
    ranges = [list(r) for r in (normal_pos_range, normal_neg_range, noisy_pos_range,
                                noisy_neg_range)]
    if len(ranges[0]) != len(ranges[1]):
        raise ValueError("specified_split: normal pos/neg ranges must have equal length")
    if len(ranges[2]) != len(ranges[3]):
        raise ValueError("specified_split: noisy pos/neg ranges must have equal length")

    def split(idx):
        n_train = int((1 - val_fraction) * len(idx))
        return idx[:n_train], idx[n_train:]

    (tr_np, va_np), (tr_nn, va_nn), (tr_zp, va_zp), (tr_zn, va_zn) = map(split, ranges)
    interleave = lambda a, b: [v for pair in zip(a, b) for v in pair]
    train = interleave(tr_np, tr_nn) + interleave(tr_zp, tr_zn)
    val = interleave(va_np, va_nn) + interleave(va_zp, va_zn)
    return np.asarray(train, dtype=np.int64), np.asarray(val, dtype=np.int64)
