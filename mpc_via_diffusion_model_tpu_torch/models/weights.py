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

``to_flax_params`` is its exact inverse, flip included, so weights that the
port trains pickle in the JAX package's layout; ``init_like_flax`` draws
the initial weights that flax's default initializers draw.

``load_flagship`` reads ``artifacts/flagship/ema_params.pkl`` (the layout
``{'ema_params', 'step', 'cfg_indicator'}``), ``load_student`` a distilled
student such as ``artifacts/onpolicy_cartpole/student_1eval.pkl`` (the
layout ``{'params'}``, built with ``cfg_indicator=True`` as the students are
trained), both of the flagship architecture (``FLAGSHIP_CONFIG``), and
``load_teacher`` the students' horizon-64 teacher
(``artifacts/flagship_modality/ema_params.pkl``, ``TEACHER_CONFIG``), and
``load_lmpc`` the LMPC parity workload's denoiser,
``artifacts/flagship_lmpc/ema_params.pkl`` (``LMPC_CONFIG``, the flagship's
layout), and ``load_quadrotor_student`` the quadrotor's 1-eval student
(``QUADROTOR_STUDENT_CONFIG``, the students' layout), and
``load_quadrotor_teacher`` the quadrotor flagship's guided teacher
(``artifacts/flagship_quadrotor/ema_params.pkl``,
``QUADROTOR_TEACHER_CONFIG``, the ``{'params'}`` layout), and
``load_panda_student`` the panda arm's on-policy 1-eval student
(``artifacts/onpolicy_panda/student_1eval.pkl``, ``PANDA_STUDENT_CONFIG``),
and ``load_panda_teacher`` its CFG teacher
(``artifacts/flagship_panda_rbd/ema_params.pkl``, the same architecture).
All are plain dicts of float32 numpy arrays that need neither jax
nor flax to unpickle.

The MLPs (``AMPCNet``, any module of ``nn.Linear`` layers): flax numbers
its Dense layers ``Dense_0, Dense_1, ...`` in call order, which is the
order of the module's ``nn.Linear`` layers; ``mlp_from_flax_params`` and
``mlp_to_flax_params`` carry them both ways (kernel (in, out) = weight.T),
``init_mlp_like_flax`` draws flax's Dense init, and ``load_ampc`` reads the
``ampc.ckpt`` that ``scripts/train_ampc.py`` writes.
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .ampc import AMPCNet
from .temporal_unet import TemporalUnet

__all__ = ["FLAGSHIP_CONFIG", "LMPC_CONFIG", "PANDA_STUDENT_CONFIG", "QUADROTOR_STUDENT_CONFIG",
           "QUADROTOR_TEACHER_CONFIG", "SCENE_STUDENT_CONFIG", "TEACHER_CONFIG",
           "from_flax_params", "init_like_flax", "init_mlp_like_flax", "load_ampc",
           "load_flagship", "load_lmpc", "load_panda_student", "load_panda_teacher",
           "load_quadrotor_student",
           "load_quadrotor_teacher",
           "load_scene_student",
           "load_student", "load_teacher", "mlp_from_flax_params", "mlp_to_flax_params",
           "to_flax_params"]

# artifacts/flagship/args.yaml: horizon 32, unet_input_dim 32, dim_mults (1,2,4), context 5
FLAGSHIP_CONFIG = dict(state_dim=1, n_support_points=32, unet_input_dim=32,
                       dim_mults=(1, 2, 4), time_emb_dim=32, context_dim=5)
# artifacts/flagship_modality/args.yaml: the flagship's architecture at horizon 64, the
# distilled students' teacher
TEACHER_CONFIG = dict(FLAGSHIP_CONFIG, n_support_points=64)
# scripts/flagship_lmpc.py: horizon 8, unet_input_dim 32, dim_mults (1,2,4), context 4
LMPC_CONFIG = dict(state_dim=1, n_support_points=8, unet_input_dim=32, dim_mults=(1, 2, 4),
                   time_emb_dim=32, context_dim=4)
# scripts/bench_quadrotor_student.py: 4 controls, horizon 48, unet_input_dim 32, dim_mults
# (1,2,4), the 12-dim quadrotor state as context
QUADROTOR_STUDENT_CONFIG = dict(state_dim=4, n_support_points=48, unet_input_dim=32,
                                dim_mults=(1, 2, 4), time_emb_dim=32, context_dim=12)
# scripts/flagship_quadrotor.py: the teacher the quadrotor students were distilled from, at
# the students' widths
QUADROTOR_TEACHER_CONFIG = dict(QUADROTOR_STUDENT_CONFIG)
# artifacts/scene_conditioned/scene_student_ema.pkl: the quadrotor's widths, context 12 + 12
# scene features
SCENE_STUDENT_CONFIG = dict(QUADROTOR_STUDENT_CONFIG, context_dim=24)
# artifacts/onpolicy_panda/student_1eval.pkl (scripts/bench_panda_student.py:82-84 of the JAX
# package): horizon 128, the 7 joint torques, widths 32/64/128, the 20-dim arm context
PANDA_STUDENT_CONFIG = dict(state_dim=7, n_support_points=128, unet_input_dim=32,
                            dim_mults=(1, 2, 4), time_emb_dim=32, context_dim=20)


def _unet_layers(n_levels: int) -> List[Tuple[str, Tuple[str, ...], str]]:
    """(torch module path, flax module path, kind) of every layer of a
    ``TemporalUnet`` with ``n_levels`` levels that holds parameters, in
    flax's order; kind ``conv?`` is a residual 1x1 conv that exists only
    where a block changes its channel count."""
    out = [("time_mlp.encoder.1", ("TimeEncoder_0", "Dense_0"), "dense"),
           ("time_mlp.encoder.3", ("TimeEncoder_0", "Dense_1"), "dense")]
    rtb = iter(range(4 * n_levels))

    def res_block(prefix):
        name = f"ResidualTemporalBlock_{next(rtb)}"
        for i in (0, 1):
            out.append((f"{prefix}.blocks.{i}.block.0", (name, f"Conv1dBlock_{i}", "Conv_0"),
                        "conv"))
            out.append((f"{prefix}.blocks.{i}.block.2", (name, f"Conv1dBlock_{i}", "GroupNorm_0"),
                        "group_norm"))
        out.append((f"{prefix}.cond_mlp.1", (name, "Dense_0"), "dense"))
        out.append((f"{prefix}.residual_conv", (name, "Conv_0"), "conv?"))

    for lvl in range(n_levels):
        res_block(f"downs.{lvl}.0")
        res_block(f"downs.{lvl}.1")
        if lvl < n_levels - 1:
            out.append((f"downs.{lvl}.4.conv", (f"Downsample1d_{lvl}", "Conv_0"), "conv"))
    res_block("mid_block1")
    res_block("mid_block2")
    for j in range(n_levels - 1):
        res_block(f"ups.{j}.0")
        res_block(f"ups.{j}.1")
        out.append((f"ups.{j}.4.conv", (f"Upsample1d_{j}", "ConvTranspose_0"), "conv_transpose"))
    out.append(("final_conv.0.block.0", ("Conv1dBlock_0", "Conv_0"), "conv"))
    out.append(("final_conv.0.block.2", ("Conv1dBlock_0", "GroupNorm_0"), "group_norm"))
    out.append(("final_conv.1", ("Conv_0",), "conv"))
    return out


# flax kernel (k, in, out) or (in, out) -> torch weight, and back; the
# transposed conv's kernel is flipped along k (see layers.Upsample1d)
_TO_TORCH = {"dense": lambda k: k.T, "conv": lambda k: k.transpose(2, 1, 0),
             "conv_transpose": lambda k: k[::-1].transpose(1, 2, 0)}
_TO_FLAX = {"dense": lambda w: w.T, "conv": lambda w: w.transpose(2, 1, 0),
            "conv_transpose": lambda w: w.transpose(2, 0, 1)[::-1]}
_LEAVES = {"group_norm": ("scale", "bias")}  # every other kind: ("kernel", "bias")


def _subtree(tree: Mapping, path: Tuple[str, ...]):
    for name in path:
        if name not in tree:
            return None
        tree = tree[name]
    return tree


def from_flax_params(params: Mapping, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """Flax ``TemporalUnet`` params (``{'params': ...}`` or the inner dict,
    numpy or array leaves) -> a state dict for this package's ``TemporalUnet``,
    in ``dtype``."""
    p = params["params"] if "params" in params else params
    n_levels = 1 + sum(k.startswith("Downsample1d_") for k in p)
    sd: Dict[str, torch.Tensor] = {}
    arr = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype)))
    for key, path, kind in _unet_layers(n_levels):
        d = _subtree(p, path)
        if d is None and kind == "conv?":
            continue
        kind = kind.rstrip("?")
        first, bias = _LEAVES.get(kind, ("kernel", "bias"))
        w = np.asarray(d[first])
        sd[key + ".weight"] = arr(w if kind == "group_norm" else _TO_TORCH[kind](w))
        sd[key + ".bias"] = arr(d[bias])
    return sd


def _state_dict(model_or_sd) -> Mapping[str, torch.Tensor]:
    if isinstance(model_or_sd, torch.nn.Module):
        return dict(model_or_sd.named_parameters())
    return model_or_sd


def to_flax_params(model_or_sd) -> Dict[str, Dict]:
    """The exact inverse of ``from_flax_params``: a ``TemporalUnet`` (or its
    state dict, or any dict of tensors under its parameter names, such as
    Adam's moments) -> ``{'params': ...}`` in the flax layout, numpy leaves
    of the tensors' dtype, as the JAX package's ``model.init`` returns them."""
    sd = _state_dict(model_or_sd)
    n_levels = 1 + sum(k.startswith("downs.") and k.endswith(".4.conv.weight") for k in sd)
    p: Dict[str, Dict] = {}
    for key, path, kind in _unet_layers(n_levels):
        if key + ".weight" not in sd and kind == "conv?":
            continue
        kind = kind.rstrip("?")
        first, bias = _LEAVES.get(kind, ("kernel", "bias"))
        w = sd[key + ".weight"].detach().cpu().numpy()
        d = p
        for name in path:
            d = d.setdefault(name, {})
        d[first] = np.array(w if kind == "group_norm" else _TO_FLAX[kind](w), order="C")
        d[bias] = sd[key + ".bias"].detach().cpu().numpy().copy()
    return {"params": p}


# flax's lecun_normal: a normal truncated at +-2 standard units, scaled by
# sqrt(1 / fan_in) / TRUNC_STD so that the truncated draw has std sqrt(1 / fan_in)
TRUNC_STD = 0.87962566103423978


def _truncated_normal(generator, shape: Tuple[int, ...]) -> np.ndarray:
    """Standard normal draws truncated to [-2, 2] by redrawing each one
    outside, in float64 numpy; from a numpy ``RandomState`` or a
    ``torch.Generator`` (drawn on its device)."""
    n = int(np.prod(shape))
    if isinstance(generator, np.random.RandomState):
        x = generator.standard_normal(n)
        while (bad := np.abs(x) > 2.0).any():
            x[bad] = generator.standard_normal(int(bad.sum()))
        return x.reshape(shape)
    dev = generator.device
    x = torch.randn(n, generator=generator, dtype=torch.float64, device=dev)
    while (bad := x.abs() > 2.0).any():
        x[bad] = torch.randn(int(bad.sum()), generator=generator, dtype=torch.float64, device=dev)
    return x.cpu().numpy().reshape(shape)


@torch.no_grad()
def init_like_flax(model: TemporalUnet, generator) -> TemporalUnet:
    """Sets ``model``'s parameters in place, on its device, to what flax's
    default initializers draw for the JAX ``TemporalUnet``: every Dense,
    Conv and ConvTranspose kernel lecun_normal (fan_in the kernel's input
    count times its width, in flax's kernel layout), every bias 0, every
    GroupNorm scale 1 and bias 0. ``generator`` is a numpy ``RandomState``
    or a ``torch.Generator``; the kernels are drawn in flax's layer order,
    each in flax's kernel layout. Returns the model."""
    sd = dict(model.named_parameters())
    flax: Dict[str, Dict] = {}
    for key, path, kind in _unet_layers(len(model.downs)):
        if key + ".weight" not in sd:
            continue
        kind = kind.rstrip("?")
        d = flax
        for name in path:
            d = d.setdefault(name, {})
        n_out = sd[key + ".bias"].numel()
        if kind == "group_norm":
            d["scale"], d["bias"] = np.ones(n_out, np.float32), np.zeros(n_out, np.float32)
            continue
        shape = tuple(_TO_FLAX[kind](sd[key + ".weight"].detach().cpu().numpy()).shape)
        fan_in = int(np.prod(shape[:-1]))
        std = np.sqrt(1.0 / fan_in) / TRUNC_STD
        d["kernel"] = (_truncated_normal(generator, shape) * std).astype(np.float32)
        d["bias"] = np.zeros(n_out, np.float32)
    new = from_flax_params(flax)
    if set(new) != set(sd):
        raise ValueError(f"init_like_flax: layers not covered {sorted(set(sd) ^ set(new))}")
    for key, value in new.items():
        sd[key].copy_(value)
    return model


def _load_unet(path, params_key: str, cfg_indicator, device,
               config: Mapping = FLAGSHIP_CONFIG) -> TemporalUnet:
    """A ``TemporalUnet`` of ``config`` from the pickle at ``path``, its flax
    params under ``params_key``, in eval mode on ``device`` (``cuda`` unless
    given). ``cfg_indicator`` is a bool, or the key that holds it."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    bit = ckpt[cfg_indicator] if isinstance(cfg_indicator, str) else cfg_indicator
    model = TemporalUnet(**config, cfg_indicator=bool(bit))
    model.load_state_dict(from_flax_params(ckpt[params_key]))
    return model.to(dev).eval()


def load_flagship(path, device=None) -> TemporalUnet:
    """The trained flagship denoiser (1,001,825 params) from its EMA pickle."""
    return _load_unet(path, "ema_params", "cfg_indicator", device)


def load_student(path, device=None) -> TemporalUnet:
    """A distilled student of the flagship (1,001,825 params) from its
    ``{'params'}`` pickle; students are trained with the context-present bit."""
    return _load_unet(path, "params", True, device)


def load_teacher(path, device=None) -> TemporalUnet:
    """The distilled students' teacher, ``artifacts/flagship_modality/ema_params.pkl``
    (1,001,825 params, horizon 64, the context-present bit), from its ``{'params'}`` pickle."""
    return _load_unet(path, "params", True, device, TEACHER_CONFIG)


def load_quadrotor_student(path, device=None) -> TemporalUnet:
    """The quadrotor's self-distilled student,
    ``artifacts/onpolicy_quadrotor/student_1eval.pkl`` (``QUADROTOR_STUDENT_CONFIG``,
    the context-present bit), from its ``{'params'}`` pickle."""
    return _load_unet(path, "params", True, device, QUADROTOR_STUDENT_CONFIG)


def load_quadrotor_teacher(path, device=None) -> TemporalUnet:
    """The quadrotor flagship's teacher, ``artifacts/flagship_quadrotor/ema_params.pkl``
    (``QUADROTOR_TEACHER_CONFIG``: horizon 48, 4 channels, context 12, the
    context-present bit), from its ``{'params'}`` pickle."""
    return _load_unet(path, "params", True, device, QUADROTOR_TEACHER_CONFIG)


def load_scene_student(path, device=None) -> TemporalUnet:
    """The scene-conditioned quadrotor student,
    ``artifacts/scene_conditioned/scene_student_ema.pkl`` (1,019,524 params,
    ``SCENE_STUDENT_CONFIG``: context 24, the 12-state then 12 scene
    features, the context-present bit), from its ``{'params'}`` pickle."""
    return _load_unet(path, "params", True, device, SCENE_STUDENT_CONFIG)


def load_panda_student(path, device=None) -> TemporalUnet:
    """The panda arm's on-policy (DAgger) 1-eval student,
    ``artifacts/onpolicy_panda/student_1eval.pkl`` (1,016,615 params,
    ``PANDA_STUDENT_CONFIG``: horizon 128, 7 channels, context 20, the
    context-present bit), from its ``{'params'}`` pickle."""
    return _load_unet(path, "params", True, device, PANDA_STUDENT_CONFIG)


def load_panda_teacher(path, device=None) -> TemporalUnet:
    """The panda arm's CFG teacher, ``artifacts/flagship_panda_rbd/ema_params.pkl``
    (1,016,615 params, the student's ``PANDA_STUDENT_CONFIG``), from its
    ``{'ema_params', 'step', 'cfg_indicator'}`` pickle, as the JAX package's
    ``scripts/bench_highdim.py`` builds it."""
    return _load_unet(path, "ema_params", "cfg_indicator", device, PANDA_STUDENT_CONFIG)


def load_lmpc(path, device=None) -> TemporalUnet:
    """The LMPC parity workload's denoiser (1,000,929 params, horizon 8,
    context 4) from its EMA pickle."""
    return _load_unet(path, "ema_params", "cfg_indicator", device, LMPC_CONFIG)


def _dense_names(model: torch.nn.Module) -> List[Tuple[str, str]]:
    """(torch module path, flax ``Dense_i``) of every ``nn.Linear``, in order."""
    linears = [n for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)]
    return [(n, f"Dense_{i}") for i, n in enumerate(linears)]


def mlp_from_flax_params(params: Mapping, model: torch.nn.Module,
                         dtype=np.float32) -> Dict[str, torch.Tensor]:
    """Flax Dense params (``{'params': ...}`` or the inner dict) -> a state
    dict for ``model``, whose ``nn.Linear`` layers are ``Dense_0, 1, ...``."""
    p = params["params"] if "params" in params else params
    names = _dense_names(model)
    if set(p) != {d for _, d in names}:
        raise ValueError(f"flax layers {sorted(p)} do not match the module's {names}")
    arr = lambda a: torch.from_numpy(np.array(a, dtype))
    sd: Dict[str, torch.Tensor] = {}
    for key, dense in names:
        sd[key + ".weight"] = arr(np.asarray(p[dense]["kernel"]).T)
        sd[key + ".bias"] = arr(p[dense]["bias"])
    return sd


def mlp_to_flax_params(model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor] = None) -> Dict:
    """The inverse of ``mlp_from_flax_params``: ``model``'s Linear layers (or
    ``state_dict``, tensors under its parameter names) -> ``{'params':
    {'Dense_i': {'kernel', 'bias'}}}`` of numpy arrays."""
    sd = dict(model.named_parameters()) if state_dict is None else state_dict
    return {"params": {dense: {"kernel": np.array(sd[key + ".weight"].detach().cpu().numpy().T,
                                                  order="C"),
                               "bias": sd[key + ".bias"].detach().cpu().numpy().copy()}
                       for key, dense in _dense_names(model)}}


@torch.no_grad()
def init_mlp_like_flax(model: torch.nn.Module, generator) -> torch.nn.Module:
    """Sets every ``nn.Linear`` of ``model`` in place, in flax's layer order,
    to flax's Dense init: the kernel (in, out) lecun_normal, the bias 0.
    ``generator`` is a numpy ``RandomState`` or a ``torch.Generator``."""
    for key, _ in _dense_names(model):
        layer = model.get_submodule(key)
        fan_in = layer.in_features
        k = _truncated_normal(generator, (fan_in, layer.out_features)) * (np.sqrt(1.0 / fan_in)
                                                                           / TRUNC_STD)
        layer.weight.copy_(torch.from_numpy(k.astype(np.float32).T.copy()))
        layer.bias.zero_()
    return model


def load_ampc(path, device=None, params_key: str = "ema_params") -> AMPCNet:
    """An ``AMPCNet`` from the ``ampc.ckpt`` pickle (``{'params',
    'ema_params', 'horizon', 'control_dim'}``) that the JAX package's and the
    port's ``train_ampc`` write, its widths read off the kernels, in eval
    mode on ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    p = ckpt[params_key]
    p = p["params"] if "params" in p else p
    kernels = [np.asarray(p[f"Dense_{i}"]["kernel"]) for i in range(len(p))]
    model = AMPCNet(int(ckpt["horizon"]), int(ckpt["control_dim"]),
                    hidden=[k.shape[1] for k in kernels[:-1]], state_dim=kernels[0].shape[0])
    model.load_state_dict(mlp_from_flax_params(p, model))
    return model.to(dev).eval()
