"""Layers and the U-Net of the PyTorch port against the flax modules of the
JAX package, on random weights (numpy seeds) and on the flagship weights.

Port layers work in (B, C, H); flax in (B, H, C). Single-layer forwards are
held to 1e-5: both sides run the same fp32 formulas and differ only in
summation order.
"""
from pathlib import Path
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu.models import layers as jl
from mpc_via_diffusion_model_tpu.models.torch_import import import_reference_unet
from mpc_via_diffusion_model_tpu_torch.models import (FLAGSHIP_CONFIG, from_flax_params,
                                                      load_flagship)
from mpc_via_diffusion_model_tpu_torch.models import layers as tl
from torch_port_util import randomize

FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts" / "flagship" / "ema_params.pkl"
TOL = 1e-5


def _init(module, *args, seed=0):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return randomize(shapes, seed)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _load_conv(conv, d):
    conv.weight.data = _t(np.asarray(d["kernel"]).transpose(2, 1, 0))
    conv.bias.data = _t(d["bias"])


def _load_block(block, d):
    """flax Conv1dBlock {Conv_0, GroupNorm_0} -> port Conv1dBlock"""
    _load_conv(block.block[0], d["Conv_0"])
    block.block[2].weight.data = _t(d["GroupNorm_0"]["scale"])
    block.block[2].bias.data = _t(d["GroupNorm_0"]["bias"])


def _bhc(x):  # (B, C, H) torch -> (B, H, C) numpy
    return x.detach().numpy().transpose(0, 2, 1)


def test_mish_matches_jax():
    x = np.concatenate([np.linspace(-60, 60, 241), np.random.RandomState(0).randn(500) * 5])
    x = x.astype(np.float32)
    got = tl.mish(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.mish(jnp.asarray(x))), rtol=2e-6, atol=1e-7)
    assert np.all(np.isfinite(tl.mish(torch.tensor([-1e4, 1e4, 88.0, 100.0])).numpy()))


def test_group_norm_n_groups_matches_jax():
    for c in (1, 4, 7, 8, 12, 16, 32, 64, 100, 128, 256, 97):
        assert tl.group_norm_n_groups(c) == jl.group_norm_n_groups(c)
    assert [tl.group_norm_n_groups(c) for c in (32, 64, 128)] == [8, 8, 8]


def test_time_encoder_matches_flax():
    t = np.array([0, 1, 7, 24, 3], np.int32)
    jm = jl.TimeEncoder(32, 32)
    params = _init(jm, jnp.asarray(t))
    tm = tl.TimeEncoder(32, 32)
    d = params["params"]
    for idx, name in ((1, "Dense_0"), (3, "Dense_1")):
        tm.encoder[idx].weight.data = _t(np.asarray(d[name]["kernel"]).T)
        tm.encoder[idx].bias.data = _t(d[name]["bias"])
    got = tm(torch.from_numpy(t)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(params, jnp.asarray(t))), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tl.SinusoidalPosEmb(32)(torch.from_numpy(t)).numpy(),
                               np.asarray(jl.SinusoidalPosEmb(32).apply({}, jnp.asarray(t))),
                               atol=TOL)


def test_conv1d_block_matches_flax():
    x = np.random.RandomState(1).randn(2, 16, 8).astype(np.float32)
    jm = jl.Conv1dBlock(16, 5, 8)
    params = _init(jm, jnp.asarray(x))
    tm = tl.Conv1dBlock(8, 16, 5, 8)
    _load_block(tm, params["params"])
    got = _bhc(tm(torch.from_numpy(x.transpose(0, 2, 1))))
    np.testing.assert_allclose(got, np.asarray(jm.apply(params, jnp.asarray(x))), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 16)])
def test_residual_block_matches_flax(cin, cout):
    """With a 1x1 residual conv (channels change) and without."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, cin).astype(np.float32)
    c = rng.randn(2, 38).astype(np.float32)
    jm = jl.ResidualTemporalBlock(cout)
    params = _init(jm, jnp.asarray(x), jnp.asarray(c))
    p = params["params"]
    tm = tl.ResidualTemporalBlock(cin, cout, 38)
    for i in (0, 1):
        _load_block(tm.blocks[i], p[f"Conv1dBlock_{i}"])
    tm.cond_mlp[1].weight.data = _t(np.asarray(p["Dense_0"]["kernel"]).T)
    tm.cond_mlp[1].bias.data = _t(p["Dense_0"]["bias"])
    assert ("Conv_0" in p) == (cin != cout)
    if cin != cout:
        _load_conv(tm.residual_conv, p["Conv_0"])
    got = _bhc(tm(torch.from_numpy(x.transpose(0, 2, 1)), torch.from_numpy(c)))
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_downsample_matches_flax():
    x = np.random.RandomState(3).randn(2, 16, 8).astype(np.float32)
    jm = jl.Downsample1d(8)
    params = _init(jm, jnp.asarray(x))
    tm = tl.Downsample1d(8)
    _load_conv(tm.conv, params["params"]["Conv_0"])
    got = _bhc(tm(torch.from_numpy(x.transpose(0, 2, 1))))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    assert got.shape == (2, 8, 8)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_upsample_matches_flax_conv_transpose():
    """flax ConvTranspose(k4, s2, padding (2, 2)) does not flip its kernel;
    the port's ConvTranspose1d(k4, s2, p1) matches it with the kernel
    flipped along k, and does not match it unflipped."""
    x = np.random.RandomState(4).randn(2, 8, 6).astype(np.float32)
    jm = jl.Upsample1d(6)
    params = _init(jm, jnp.asarray(x), seed=5)
    kernel = np.asarray(params["params"]["ConvTranspose_0"]["kernel"])  # (k, in, out)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    assert want.shape == (2, 16, 6)
    # the closed form the kernel uses
    xb = np.pad(x, ((0, 0), (1, 1), (0, 0)))
    bias = np.asarray(params["params"]["ConvTranspose_0"]["bias"])
    even = bias + xb[:, :-2] @ kernel[0] + xb[:, 1:-1] @ kernel[2]
    odd = bias + xb[:, 1:-1] @ kernel[1] + xb[:, 2:] @ kernel[3]
    np.testing.assert_allclose(np.stack([even, odd], 2).reshape(2, 16, 6), want, atol=TOL, rtol=TOL)
    sd = from_flax_params({"params": _unet_params_with_upsample(params["params"])})
    tm = tl.Upsample1d(6)
    tm.conv.weight.data = sd["ups.0.4.conv.weight"]
    tm.conv.bias.data = sd["ups.0.4.conv.bias"]
    got = _bhc(tm(torch.from_numpy(x.transpose(0, 2, 1))))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    tm.conv.weight.data = _t(kernel.transpose(1, 2, 0))  # no flip
    assert np.abs(_bhc(tm(torch.from_numpy(x.transpose(0, 2, 1)))) - want).max() > 1e-2


def _unet_params_with_upsample(up_params):
    """A 2-level flax U-Net param tree whose Upsample1d_0 is ``up_params``,
    so the test converts it through from_flax_params itself."""
    jm = JaxUnet(state_dim=1, n_support_points=8, unet_input_dim=6, dim_mults=(1, 1),
                 context_dim=2, conditioning_type="default")
    p = _init(jm, jnp.zeros((1, 8, 1)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 2)))["params"]
    return {**p, "Upsample1d_0": up_params}


def test_from_flax_params_inverts_torch_import():
    """flagship flax params -> port state dict -> the JAX package's
    torch-checkpoint importer -> the same flax params, leaf for leaf."""
    with open(FLAGSHIP, "rb") as f:
        ckpt = pickle.load(f)
    flax_params = ckpt["ema_params"]["params"]
    sd = from_flax_params(ckpt["ema_params"])
    back, _ = import_reference_unet({"model." + k: v.numpy() for k, v in sd.items()})
    got = jax.tree_util.tree_leaves_with_path(back["params"])
    want = dict(jax.tree_util.tree_leaves_with_path(flax_params))
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf), want[path], err_msg=str(path))


@pytest.fixture(scope="module")
def flagship_pair():
    with open(FLAGSHIP, "rb") as f:
        ckpt = pickle.load(f)
    jm = JaxUnet(conditioning_type="default", cfg_indicator=bool(ckpt["cfg_indicator"]),
                 **FLAGSHIP_CONFIG)
    return jm, ckpt["ema_params"], load_flagship(FLAGSHIP, device="cpu")


@pytest.mark.parametrize("masked", [True, False])
def test_flagship_forward_matches_flax(flagship_pair, masked):
    """The trained flagship U-Net (1,001,825 params), with a CFG context
    mask (the doubled batch's dropped rows) and without one."""
    jm, params, tm = flagship_pair
    assert sum(p.numel() for p in tm.parameters()) == 1_001_825
    rng = np.random.RandomState(6)
    x = rng.randn(4, 32, 1).astype(np.float32)
    t = np.array([0, 5, 24, 13], np.int32)
    c = rng.randn(4, 5).astype(np.float32)
    mask = np.array([[0], [1], [0], [1]], np.float32) if masked else None
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c),
                               None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(c),
                 None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
