"""Weight carry-over from the JAX package's flax parameter trees.

``from_flax_params`` is the inverse of
``mpc_via_diffusion_model_tpu/models/torch_import.py`` (which maps the
reference's torch state dict to flax):

- flax Dense kernel (in, out)       -> torch Linear weight (out, in)
- flax Conv kernel (k, in, out)     -> torch Conv1d weight (out, in, k)
- flax ConvTranspose kernel (k, in, out) -> torch ConvTranspose1d weight
  (in, out, k), FLIPPED along k: flax's transposed conv does not flip its
  kernel, torch's does (see ``layers.Upsample1d``)
- flax GroupNorm scale/bias         -> torch GroupNorm weight/bias

flax numbers the ResidualTemporalBlocks in call order: the down levels'
blocks first (two per level), then the two mid blocks, then two per up
level (``TemporalUnet.res_blocks`` lists them in that order).

``load_flagship`` reads ``artifacts/flagship/ema_params.pkl`` (the layout
``{'ema_params', 'step', 'cfg_indicator'}``) and ``load_student`` a distilled
student such as ``artifacts/onpolicy_cartpole/student_1eval.pkl`` (the
layout ``{'params'}``, built with ``cfg_indicator=True`` as the students are
trained). Both are plain dicts of float32 numpy arrays that need neither jax
nor flax to unpickle, for the flagship architecture.
"""
from __future__ import annotations

import pickle
from typing import Dict, Mapping

import numpy as np
import torch

from ..utils.device import resolve_device
from .temporal_unet import TemporalUnet

__all__ = ["FLAGSHIP_CONFIG", "from_flax_params", "load_flagship", "load_student"]

# artifacts/flagship/args.yaml: horizon 32, unet_input_dim 32, dim_mults (1,2,4), context 5
FLAGSHIP_CONFIG = dict(state_dim=1, n_support_points=32, unet_input_dim=32,
                       dim_mults=(1, 2, 4), time_emb_dim=32, context_dim=5)


def from_flax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``TemporalUnet`` params (``{'params': ...}`` or the inner dict,
    numpy or array leaves) -> a state dict for this package's ``TemporalUnet``."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    arr = lambda a: np.ascontiguousarray(np.asarray(a, np.float32))

    def put(key, a):
        sd[key] = torch.from_numpy(arr(a))

    def dense(key, d):
        put(key + ".weight", np.asarray(d["kernel"]).T)
        put(key + ".bias", d["bias"])

    def conv(key, d):
        put(key + ".weight", np.asarray(d["kernel"]).transpose(2, 1, 0))
        put(key + ".bias", d["bias"])

    def conv_transpose(key, d):
        put(key + ".weight", np.asarray(d["kernel"])[::-1].transpose(1, 2, 0))
        put(key + ".bias", d["bias"])

    def group_norm(key, d):
        put(key + ".weight", d["scale"])
        put(key + ".bias", d["bias"])

    def res_block(prefix, d):
        for i in (0, 1):
            conv(f"{prefix}.blocks.{i}.block.0", d[f"Conv1dBlock_{i}"]["Conv_0"])
            group_norm(f"{prefix}.blocks.{i}.block.2", d[f"Conv1dBlock_{i}"]["GroupNorm_0"])
        dense(f"{prefix}.cond_mlp.1", d["Dense_0"])
        if "Conv_0" in d:
            conv(f"{prefix}.residual_conv", d["Conv_0"])

    dense("time_mlp.encoder.1", p["TimeEncoder_0"]["Dense_0"])
    dense("time_mlp.encoder.3", p["TimeEncoder_0"]["Dense_1"])
    n_levels = 1 + sum(k.startswith("Downsample1d_") for k in p)
    rtb = iter(range(4 * n_levels))
    for lvl in range(n_levels):
        for i in (0, 1):
            res_block(f"downs.{lvl}.{i}", p[f"ResidualTemporalBlock_{next(rtb)}"])
        if lvl < n_levels - 1:
            conv(f"downs.{lvl}.4.conv", p[f"Downsample1d_{lvl}"]["Conv_0"])
    res_block("mid_block1", p[f"ResidualTemporalBlock_{next(rtb)}"])
    res_block("mid_block2", p[f"ResidualTemporalBlock_{next(rtb)}"])
    for j in range(n_levels - 1):
        for i in (0, 1):
            res_block(f"ups.{j}.{i}", p[f"ResidualTemporalBlock_{next(rtb)}"])
        conv_transpose(f"ups.{j}.4.conv", p[f"Upsample1d_{j}"]["ConvTranspose_0"])
    conv("final_conv.0.block.0", p["Conv1dBlock_0"]["Conv_0"])
    group_norm("final_conv.0.block.2", p["Conv1dBlock_0"]["GroupNorm_0"])
    conv("final_conv.1", p["Conv_0"])
    return sd


def _load_unet(path, params_key: str, cfg_indicator, device) -> TemporalUnet:
    """A flagship-architecture ``TemporalUnet`` from the pickle at ``path``,
    its flax params under ``params_key``, in eval mode on ``device``
    (``cuda`` unless given). ``cfg_indicator`` is a bool, or the key that
    holds it."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    bit = ckpt[cfg_indicator] if isinstance(cfg_indicator, str) else cfg_indicator
    model = TemporalUnet(**FLAGSHIP_CONFIG, cfg_indicator=bool(bit))
    model.load_state_dict(from_flax_params(ckpt[params_key]))
    return model.to(dev).eval()


def load_flagship(path, device=None) -> TemporalUnet:
    """The trained flagship denoiser (1,001,825 params) from its EMA pickle."""
    return _load_unet(path, "ema_params", "cfg_indicator", device)


def load_student(path, device=None) -> TemporalUnet:
    """A distilled student of the flagship (1,001,825 params) from its
    ``{'params'}`` pickle; students are trained with the context-present bit."""
    return _load_unet(path, "params", True, device)
