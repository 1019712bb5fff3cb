from .device import resolve_device
from .misc import (batch_jacobian, calc_output, calc_output_conv2d_transpose, dict_to_device,
                   fix_random_seed, freeze_params, from_one_hot, to_one_hot)

__all__ = ["batch_jacobian", "calc_output", "calc_output_conv2d_transpose", "dict_to_device",
           "fix_random_seed", "freeze_params", "from_one_hot", "resolve_device", "to_one_hot"]
