"""Device and precision policy of the port.

Counterpart of ``mpc_via_diffusion_model_tpu/utils/precision.py``: control
math stays in fp32. On the card that means TF32 off for both matmuls and
cuDNN convolutions (cuDNN allows TF32 by default, which keeps about three
decimal digits).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and there is no
    card. Pins the fp32 precision policy as a side effect."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless device='cpu' is passed")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
