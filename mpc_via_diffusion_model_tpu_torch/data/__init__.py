from .datasets import ControlSequenceDataset, specified_split, train_val_split
from .generation import LmpcDataset, collect_lmpc_dataset
from .lmpc_stats import lmpc_stats
from .normalization import (NORMALIZERS, DatasetNormalizer, NormalizerStats, canonical_kind,
                            fit_normalizer, normalize, unnormalize)

__all__ = ["NORMALIZERS", "ControlSequenceDataset", "DatasetNormalizer", "LmpcDataset",
           "NormalizerStats", "canonical_kind", "collect_lmpc_dataset", "fit_normalizer",
           "lmpc_stats", "normalize", "specified_split", "train_val_split", "unnormalize"]
