from .temporal_unet import TemporalUnet
from .weights import (FLAGSHIP_CONFIG, LMPC_CONFIG, from_flax_params, init_like_flax,
                      load_flagship, load_lmpc, load_student, to_flax_params)

__all__ = ["TemporalUnet", "FLAGSHIP_CONFIG", "LMPC_CONFIG", "from_flax_params", "init_like_flax",
           "load_flagship", "load_lmpc", "load_student", "to_flax_params"]
