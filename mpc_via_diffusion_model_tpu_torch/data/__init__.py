from .generation import LmpcDataset, collect_lmpc_dataset
from .lmpc_stats import lmpc_stats
from .normalization import (NORMALIZERS, DatasetNormalizer, NormalizerStats, canonical_kind,
                            fit_normalizer, normalize, unnormalize)

__all__ = ["NORMALIZERS", "DatasetNormalizer", "LmpcDataset", "NormalizerStats", "canonical_kind",
           "collect_lmpc_dataset", "fit_normalizer", "lmpc_stats", "normalize", "unnormalize"]
