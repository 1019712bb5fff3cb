from .temporal_unet import TemporalUnet
from .weights import FLAGSHIP_CONFIG, from_flax_params, load_flagship, load_student

__all__ = ["TemporalUnet", "FLAGSHIP_CONFIG", "from_flax_params", "load_flagship", "load_student"]
