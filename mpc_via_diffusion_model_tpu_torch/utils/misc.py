"""Small utilities: port of ``mpc_via_diffusion_model_tpu/utils/misc.py``.

- ``to_one_hot`` / ``from_one_hot``: float32 one-hot rows (all zeros for a
  number outside [min_val, max_val), as ``jax.nn.one_hot`` gives) and their
  argmax;
- ``batch_jacobian``: the Jacobian of ``fn`` per batch row, by
  ``torch.func``;
- ``calc_output`` / ``calc_output_conv2d_transpose``: the reference's conv
  shape arithmetic;
- ``fix_random_seed``: a seeded ``torch.Generator``, the counterpart of the
  JAX package's root PRNG key (nothing global is seeded);
- ``freeze_params``: gradient-stopped copies of a dict of tensors;
- ``dict_to_device``: a dict of tensors moved to a device.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

from .device import resolve_device

__all__ = ["to_one_hot", "from_one_hot", "batch_jacobian", "calc_output",
           "calc_output_conv2d_transpose", "fix_random_seed", "freeze_params", "dict_to_device"]


def to_one_hot(number, max_val: int, min_val: int = 0) -> torch.Tensor:
    if not max_val > min_val:
        raise ValueError("max_val must exceed min_val")
    number = torch.as_tensor(number)
    classes = torch.arange(max_val - min_val, device=number.device)
    return (number[..., None] - min_val == classes).to(torch.float32)


def from_one_hot(hot: torch.Tensor) -> torch.Tensor:
    return torch.argmax(hot, dim=-1)


def batch_jacobian(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(B, in) -> (B, out, in): ``fn`` maps one row (in,) to (out,)."""
    return torch.func.vmap(torch.func.jacrev(fn))(x)


def calc_output(in_dim, filter_size, padding=0, stride=1):
    x = in_dim - filter_size + (2 * padding) + (filter_size % 2)
    return (x / stride) + (1 - (filter_size % 2))


def calc_output_conv2d_transpose(in_dim, filter_size, padding=0, stride=1, dilation=1):
    return (in_dim - 1) * stride - 2 * padding + dilation * (filter_size - 1) + 1


def fix_random_seed(seed: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)


def freeze_params(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Gradient-stopped views of a dict of parameter tensors."""
    return {k: v.detach() for k, v in params.items()}


def dict_to_device(batch: Mapping[str, torch.Tensor], device=None) -> Dict[str, torch.Tensor]:
    """Each tensor of ``batch`` on ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in batch.items()}
