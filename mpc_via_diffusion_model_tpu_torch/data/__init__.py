from .normalization import (NORMALIZERS, DatasetNormalizer, NormalizerStats, canonical_kind,
                            fit_normalizer, normalize, unnormalize)

__all__ = ["NORMALIZERS", "DatasetNormalizer", "NormalizerStats", "canonical_kind",
           "fit_normalizer", "normalize", "unnormalize"]
