"""The port's fused Conv1d + GroupNorm + Mish (ops/fused_conv.py) against
the JAX package's ``ops/fused_conv.py``: its XLA reference, its Pallas kernel
body run in interpret mode, flax's weights carried into the port's
``Conv1dBlock``, and the CUDA kernel's program emulated in numpy.

Inputs are numpy draws at the six shapes of ``scripts/bench_kernels.py``,
with b, gamma and beta drawn too (the bench's zeros and ones would hide a
layout mistake). Tolerances:
- atol = rtol = 1e-5 against the JAX functions: the same fp32 formula, with
  the products summed in other orders (measured up to 3e-6 with gamma ~ N(0, 1));
- the Pallas body and the CUDA kernel's program compute the group variance
  as E[y^2] - mean^2, the references in two passes: the same 1e-5, since the
  outputs are O(1) and the groups' variances far from 0;
- rtol = 2e-4, atol = 2e-5 against ``Conv1dBlock``, test_ops.py's for flax
  (cuDNN-free torch conv against the einsum taps).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mpc_via_diffusion_model_tpu.models.layers import Conv1dBlock as FlaxConv1dBlock
from mpc_via_diffusion_model_tpu.ops import fused_conv as jax_fused_conv
from mpc_via_diffusion_model_tpu_torch.models.layers import Conv1dBlock
from mpc_via_diffusion_model_tpu_torch.ops import (conv1d_gn_mish_reference,
                                                   fused_conv1d_gn_mish)
from mpc_via_diffusion_model_tpu_torch.ops.fused_conv import (FusedConv1dGnMish,
                                                              conv_smem_bytes)
from mpc_via_diffusion_model_tpu_torch.ops.unet_pack import SMEM_LIMIT
from torch_port_util import emulate_fused_conv_kernel

SHAPES = [(2, 32, 1, 32), (2, 32, 32, 32), (2, 16, 32, 64), (2, 8, 64, 128),
          (64, 32, 32, 32), (64, 8, 64, 128)]
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(shape, seed: int = 0):
    """x, w, b, gamma, beta, pre_bias as float32 numpy, and the bench's groups."""
    bsz, h, cin, cout = shape
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return (f(bsz, h, cin), f(5, cin, cout) * np.float32(0.1), f(cout), f(cout), f(cout),
            f(bsz, cin)), (8 if cout % 8 == 0 else 1)


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("with_pre_bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_reference(shape, with_pre_bias):
    (x, w, b, g, be, pb), groups = _inputs(shape)
    pb = pb if with_pre_bias else None
    want = np.asarray(jax_fused_conv.conv1d_gn_mish_reference(x, w, b, g, be, groups, pb))
    # off the TPU the JAX function is its reference: the same numbers
    np.testing.assert_array_equal(
        np.asarray(jax_fused_conv.fused_conv1d_gn_mish(x, w, b, g, be, groups, pb)), want)
    args = _torch([x, w, b, g, be]) + [groups, None if pb is None else torch.from_numpy(pb)]
    np.testing.assert_allclose(conv1d_gn_mish_reference(*args).numpy(), want, **TOL)
    conv = FusedConv1dGnMish()
    np.testing.assert_allclose(conv(*args).numpy(), want, **TOL)
    assert (conv.launches, conv.plain_calls) == (0, 1)  # a CPU tensor runs the plain version


@pytest.mark.parametrize("with_pre_bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel_in_interpret_mode(shape, with_pre_bias):
    """The Pallas kernel body itself (fused_conv.py:71-123), one batch
    element per program, run by pallas_call in interpret mode."""
    (x, w, b, g, be, pb), groups = _inputs(shape, seed=1)
    bsz, h, _, cout = shape
    kernel = functools.partial(jax_fused_conv._kernel, n_groups=groups, eps=1e-5,
                               has_pre_bias=with_pre_bias)
    want = np.asarray(pl.pallas_call(
        kernel, grid=(bsz,), out_shape=jax.ShapeDtypeStruct((bsz, h, cout), jnp.float32),
        interpret=True)(x, w, b, g, be, pb if with_pre_bias else np.zeros_like(pb)))
    got = fused_conv1d_gn_mish(*_torch([x, w, b, g, be]), groups,
                               torch.from_numpy(pb) if with_pre_bias else None)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", [(2, 32, 1, 32), (4, 16, 32, 64), (2, 8, 64, 128)])
def test_plain_matches_conv1dblock_with_flax_weights(shape):
    """As tests/test_ops.py:29-38 for flax: the port's Conv1dBlock, with the
    weights of flax's block carried across, computes the same block."""
    bsz, h, cin, cout = shape
    groups = 8 if cout % 8 == 0 else 1
    x = np.random.RandomState(2).randn(bsz, h, cin).astype(np.float32)
    params = FlaxConv1dBlock(cout, 5, groups).init(jax.random.PRNGKey(1), x)["params"]
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32) * 0.3,
                                    params)
    conv, gn = params["Conv_0"], params["GroupNorm_0"]
    block = Conv1dBlock(cin, cout, 5, groups).eval()
    block.block[0].weight.data = torch.from_numpy(np.ascontiguousarray(
        np.asarray(conv["kernel"]).transpose(2, 1, 0)))
    block.block[0].bias.data = torch.from_numpy(np.asarray(conv["bias"]))
    block.block[2].weight.data = torch.from_numpy(np.asarray(gn["scale"]))
    block.block[2].bias.data = torch.from_numpy(np.asarray(gn["bias"]))
    with torch.no_grad():
        want = block(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    got = conv1d_gn_mish_reference(
        torch.from_numpy(x), *_torch([np.asarray(conv["kernel"]), np.asarray(conv["bias"]),
                                      np.asarray(gn["scale"]), np.asarray(gn["bias"])]), groups)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
@pytest.mark.parametrize("with_pre_bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_program_emulation_matches_plain(shape, with_pre_bias, eps):
    """``csrc/fused_conv.cu``'s program (halo layout, pre-bias on the
    interior rows only, E[y^2] - mean^2 clamped at 0, eps) in numpy."""
    (x, w, b, g, be, pb), groups = _inputs(shape, seed=4)
    pb = pb if with_pre_bias else None
    got = emulate_fused_conv_kernel(x, w, b, g, be, groups, pb, eps)
    assert np.all(np.isfinite(got))
    want = conv1d_gn_mish_reference(*_torch([x, w, b, g, be]), groups,
                                    None if pb is None else torch.from_numpy(pb), eps)
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    # the kernel's shared memory is the emulator's image
    assert conv_smem_bytes(shape[1], shape[2], shape[3], groups) <= SMEM_LIMIT


def test_wrapper_refuses_what_the_kernel_does_not_take():
    (x, w, b, g, be, pb), _ = _inputs((2, 8, 4, 16))
    x, w, b, g, be, pb = _torch([x, w, b, g, be, pb])
    conv = FusedConv1dGnMish()
    refusals = [
        ((x, w, b, g, be, 8), "CUDA"),                              # a CPU tensor
        ((x, w, b, g, be, 8, pb.T.contiguous().T), "contiguous"),   # right shape, other strides
        ((x, w, b, g, be, 8, pb[:1]), "pre_bias must be"),
        ((x, w, b, g, be, 3), "multiple of n_groups"),
        ((x.double(), w, b, g, be, 8), "float32"),
        ((x, w[:3], b, g, be, 8), "w must be"),
        ((x, w, b[:4], g, be, 8), "b must be"),
        ((x[0], w, b, g, be, 8), "x must be"),
    ]
    for args, match in refusals:
        with pytest.raises(ValueError, match=match):
            conv.kernel(*args)
    big = torch.zeros((1, 400, 128)), torch.zeros((5, 128, 128))
    with pytest.raises(ValueError, match="shared memory"):
        conv.kernel(*big, *(torch.zeros(128),) * 3, 8)
    assert (conv.launches, conv.plain_calls) == (0, 0)
    with pytest.raises(ValueError, match="multiple of n_groups"):  # the plain path checks too
        conv(x, w, b, g, be, 3)


@pytest.mark.gpu
def test_fused_conv_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version on the card at the six
    shapes, with and without pre_bias: 1e-4, chip_smoke.py's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    conv = FusedConv1dGnMish()
    for shape in SHAPES:
        (x, w, b, g, be, pb), groups = _inputs(shape, seed=5)
        args = [t.cuda() for t in _torch([x, w, b, g, be])]
        for p in (None, torch.from_numpy(pb).cuda()):
            got = conv(*args, groups, p)
            torch.testing.assert_close(got, conv.plain(*args, groups, p), atol=1e-4, rtol=1e-4)
    assert conv.launches == 2 * len(SHAPES)
