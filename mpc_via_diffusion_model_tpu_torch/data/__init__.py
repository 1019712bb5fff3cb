from .normalization import NormalizerStats, normalize, unnormalize

__all__ = ["NormalizerStats", "normalize", "unnormalize"]
