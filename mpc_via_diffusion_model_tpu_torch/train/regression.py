"""MSE regression of direct policy nets: port of
``mpc_via_diffusion_model_tpu/train/regression.py``.

``fit_mlp_regression`` fits ``model(conds) -> inputs`` (the AMPC baseline's
``condition -> u-horizon`` pairs) with plain Adam (optax's ``adam``: no
gradient clip, b1 0.9, b2 0.999, eps 1e-8) and an EMA updated at every step
(no hard copy, no NaN guard), in chunks of steps that run without a host
sync, as the JAX package's ``lax.scan`` chunks do. Parameters, Adam's
moments and the EMA are flat buffers (``train/trainer.py``'s
``ParamLayout``); the module is called on views of the flat parameters.
``fit_regression_flat`` is the loop itself, which ``scripts/train_ampc.py``
also runs.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.weights import init_mlp_like_flax, mlp_from_flax_params, mlp_to_flax_params
from .trainer import Optimizer, ParamLayout, _functional, value_and_grad

__all__ = ["fit_mlp_regression", "fit_regression_flat"]

Draws = Union[torch.Tensor, torch.Generator, None]


def fit_regression_flat(model: nn.Module, inputs: torch.Tensor, conds: torch.Tensor,
                        init_params: Mapping, steps: int, batch_size: int, lr: float,
                        ema_decay: float, draws: Draws, log_every: int,
                        log_fn: Optional[Callable[[int, float], None]] = None):
    """``steps`` Adam steps of the mean square of ``model(conds[idx]) -
    inputs[idx]`` from ``init_params`` (flax Dense params), in the dtype of
    ``inputs``. ``draws``: staged indices (n_steps, B) or a generator. The
    host reads the loss only every ``log_every`` steps, where it calls
    ``log_fn(step, loss)``. Returns (layout, params, EMA, last loss)."""
    dev, dtype = inputs.device, inputs.dtype
    layout = ParamLayout.of(model)
    params = layout.flatten(mlp_from_flax_params(init_params, model, dtype=None)).to(dev, dtype)
    ema = params.clone()
    opt = Optimizer(lr, clip_grad_max_norm=float("inf"))  # optax.adam: never clipped
    opt_state = opt.init(params)
    call = _functional(model)
    n, loss = inputs.shape[0], None

    def loss_fn(p, target, cond, _draws=None):
        return torch.mean(torch.square(call(p, cond) - target))

    for s in range(steps):
        idx = draws[s] if isinstance(draws, torch.Tensor) else torch.randint(
            0, n, (batch_size,), generator=draws, device=dev)
        value, g = value_and_grad(loss_fn, layout, params, inputs[idx], conds[idx])
        updates, opt_state = opt.update(g, opt_state)
        params = params + updates
        ema = ema * ema_decay + params * (1 - ema_decay)
        if (s + 1) % log_every == 0 or s + 1 == steps:
            loss = float(value)
            if log_fn is not None:
                log_fn(s + 1, loss)
    return layout, params, ema, loss


def fit_mlp_regression(model: nn.Module, inputs: torch.Tensor, conds: torch.Tensor, *,
                       steps: int, chunk: int, batch_size: int, lr: float,
                       ema_decay: float = 0.995, seed: int = 30, verbose: bool = False,
                       init_params: Optional[Mapping] = None, draws: Draws = None
                       ) -> Tuple[Dict, float]:
    """Regress ``model(conds[idx])`` onto ``inputs[idx]`` (the mean square).

    The initial parameters are ``init_params`` (a flax ``{'params': {'Dense_i':
    ...}}`` dict, e.g. what the JAX package's ``model.init`` returns) or,
    without it, flax's Dense init drawn from ``RandomState(seed)``
    (``init_mlp_like_flax``); ``model``'s own parameters are left as they
    are. ``draws`` is the staged minibatch indices (n_steps, B) int64, or a
    ``torch.Generator`` on the data's device from which each step draws
    them (seeded ``seed + 1`` unless given). ``steps // chunk`` chunks of
    ``chunk`` steps run. Returns ``(ema_params, final_loss)``: the EMA as
    the JAX function's flax dict of numpy arrays, and the last step's loss."""
    if steps < chunk:
        raise ValueError(
            f"steps ({steps}) < chunk ({chunk}): zero chunks would run and "
            f"the untrained init would be returned as 'trained' params")
    if init_params is None:
        init_params = mlp_to_flax_params(init_mlp_like_flax(copy.deepcopy(model),
                                                            np.random.RandomState(seed)))
    if draws is None:
        draws = torch.Generator(device=inputs.device).manual_seed(seed + 1)
    n_chunks = steps // chunk
    log = (lambda s, v: print(f"  step {s} mse {v:.6f}", flush=True)
           if s % (chunk * max(1, n_chunks // 5)) == 0 else None) if verbose else None
    layout, _, ema, loss = fit_regression_flat(model, inputs, conds, init_params,
                                               n_chunks * chunk, batch_size, lr, ema_decay, draws,
                                               chunk, log)
    return mlp_to_flax_params(model, layout.views(ema)), loss
