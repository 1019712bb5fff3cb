from .datasets import ControlSequenceDataset, specified_split, train_val_split
from .generation import (collect_closed_loop_dataset, collect_lmpc_dataset,
                         make_initial_state_grid)
from .lmpc_stats import lmpc_stats
from .normalization import (NORMALIZERS, DatasetNormalizer, NormalizerStats, canonical_kind,
                            fit_normalizer, normalize, unnormalize)

__all__ = ["NORMALIZERS", "ControlSequenceDataset", "DatasetNormalizer", "NormalizerStats",
           "canonical_kind", "collect_closed_loop_dataset", "collect_lmpc_dataset",
           "fit_normalizer", "lmpc_stats", "make_initial_state_grid", "normalize", "specified_split",
           "train_val_split", "unnormalize"]
