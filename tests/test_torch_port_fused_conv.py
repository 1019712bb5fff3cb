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
import inspect

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
from mpc_via_diffusion_model_tpu_torch.ops import fused_conv as port_fused_conv
from mpc_via_diffusion_model_tpu_torch.ops.fused_conv import FusedConv1dGnMish, conv_plan
from mpc_via_diffusion_model_tpu_torch.ops.unet_pack import SMEM_LIMIT
from torch_port_util import emulate_fused_conv_kernel, mma_3xtf32, sum_3xtf32, tf32_rna

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
    """``csrc/fused_conv.cu``'s program in numpy (``emulate_fused_conv_kernel``:
    one CTA per group and batch chunk on NaN-filled shared images, mma.sync
    fragments built lane by lane in 3xTF32, the split-K reduction over the
    operands, the two-pass group statistics by shuffle trees, eps)."""
    (x, w, b, g, be, pb), groups = _inputs(shape, seed=4)
    pb = pb if with_pre_bias else None
    got = emulate_fused_conv_kernel(x, w, b, g, be, groups, pb, eps)
    assert np.all(np.isfinite(got))
    want = conv1d_gn_mish_reference(*_torch([x, w, b, g, be]), groups,
                                    None if pb is None else torch.from_numpy(pb), eps)
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    # the kernel's shared memory is the emulator's image
    assert conv_plan(*shape, groups).smem_bytes <= SMEM_LIMIT


# Shapes past the bench's, for the plan's other branches: (B, H, Cin, Cout, groups) -> what
# each exercises
RAGGED = [
    (5, 5, 6, 16, 8),    # chunk 3 with a short last chunk, cpg 2, K padded 30 -> 32, 4 splits
    (3, 8, 3, 24, 8),    # cpg 3 (odd: 4-byte copies, scalar stores), Cin 3, chunk 2 of 3
    (1, 40, 4, 8, 1),    # 3 m-tiles: 2 tile groups of 3 splits, partials past the operands
    (2, 20, 4, 24, 1),   # 2 x 3 = 6 tiles over 4 tile groups of 2 splits
    (1, 40, 8, 64, 2),   # 3 x 4 = 12 tiles over 8 tile groups, no K split
    (4, 1, 2, 8, 2),     # H = 1: chunk 4, cpg 4
    (1, 64, 8, 64, 1),   # 4 x 8 = 32 tiles, 4 per warp
    (1, 96, 2, 40, 1),   # 6 x 5 = 30 tiles, 4 on most warps, 3 on the rest
]


@pytest.mark.parametrize("shape", RAGGED)
def test_kernel_program_emulation_at_ragged_shapes(shape):
    """The emulated program against the plain version where the plan's
    rows, columns, K padding, chunks and warp cut are ragged."""
    bsz, h, cin, cout, groups = shape
    rng = np.random.RandomState(8)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    x, w, b, g, be, pb = (f(bsz, h, cin), f(5, cin, cout) * np.float32(0.3), f(cout), f(cout),
                          f(cout), f(bsz, cin))
    got = emulate_fused_conv_kernel(x, w, b, g, be, groups, pb)
    assert np.all(np.isfinite(got))
    want = conv1d_gn_mish_reference(*_torch([x, w, b, g, be]), groups, torch.from_numpy(pb))
    np.testing.assert_allclose(got, want.numpy(), **TOL)


# bench_kernels' six shapes: (cpg, chunk, CTAs, k_pad, shared memory in bytes)
PLANS = {(2, 32, 1, 32): (4, 1, 16, 8, 976), (2, 32, 32, 32): (4, 1, 16, 160, 11056),
         (2, 16, 32, 64): (8, 1, 16, 160, 8800), (2, 8, 64, 128): (16, 2, 8, 320, 38848),
         (64, 32, 32, 32): (4, 1, 512, 160, 11056), (64, 8, 64, 128): (16, 2, 256, 320, 38848)}


@pytest.mark.parametrize("shape", SHAPES)
def test_conv_plan_at_bench_shapes(shape):
    """The kernel's cut: one CTA per (group, chunk of max(1, 16 // H)
    elements), cpg and 5 * Cin padded to multiples of 8, every plan under
    the 48 KB a launch takes without the shared-memory attribute, and the
    plan's bytes the emulator's image: the operands (or the split-K
    partials over them), then bias, gamma, beta and the statistics' sums. The padded row strides put the
    32 lanes' loads of an A and a B fragment in 32 different banks."""
    bsz, h, cin, cout = shape
    groups = 8 if cout % 8 == 0 else 1
    plan = conv_plan(bsz, h, cin, cout, groups)
    cpg, chunk, ctas, k_pad, smem = PLANS[shape]
    assert (plan.cpg, plan.chunk, plan.grid, plan.k_pad) == (
        cpg, chunk, (groups, -(-bsz // chunk)), k_pad)
    assert groups * plan.grid[1] == ctas and plan.smem_bytes == smem < 48 * 1024
    assert plan.cpg_pad == 8 * -(-cpg // 8) and plan.m_tiles * 16 >= chunk * h
    assert plan.operand_floats == (k_pad * plan.w_stride + chunk * (h + 4) * plan.x_stride
                                   + k_pad)
    assert plan.partial_floats <= plan.operand_floats  # the partials fit over the operands here
    assert plan.epilogue_floats == 3 * cpg + 2 * port_fused_conv.WARPS * chunk
    assert plan.smem_bytes == 4 * (plan.operand_floats + plan.epilogue_floats)
    assert plan.tile_groups * plan.k_splits <= port_fused_conv.WARPS
    assert plan.tiles_per_warp <= port_fused_conv.MAX_TILES_PER_WARP
    g, t = np.arange(32) >> 2, np.arange(32) & 3
    assert len(set((t * plan.w_stride + g) % 32)) == 32               # b0: (k = t, n = g)
    if cin % 8 == 0:  # a k8 step within one tap: a0's column t is channel ci0 + t
        assert len(set((g * plan.x_stride + t) % 32)) == 32           # a0: (row g, k = t)


def test_3xtf32_split_is_fp32_accurate():
    """At (64, 8, 64, 128), unit-normal x and weights scaled by
    1/sqrt(5 Cin), the 3xTF32 product (the kernel's) stays within 1e-5 of
    float64 after GroupNorm; a single tf32 product misses the kernel's 1e-4
    gate there. Why the kernel splits every operand."""
    bsz, h, cin, cout, groups = 64, 8, 64, 128, 8
    rng = np.random.RandomState(7)
    x = rng.randn(bsz, h, cin).astype(np.float32)
    w = (rng.randn(5, cin, cout) / np.sqrt(5 * cin)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (2, 2), (0, 0)))
    a = np.concatenate([xp[:, k:k + h] for k in range(5)], -1).reshape(-1, 16, 5 * cin)
    wk = w.reshape(5 * cin, cout)

    def product(step, finish):  # (B, H, Cout) over the k8 steps and n8 tiles, fp32 accumulators
        acc = tuple(np.zeros((a.shape[0], 16, cout), np.float32) for _ in range(3))
        for k0 in range(0, 5 * cin, 8):
            for n0 in range(0, cout, 8):
                tiles = step(tuple(c[..., n0:n0 + 8] for c in acc), a[..., k0:k0 + 8],
                             wk[k0:k0 + 8, n0:n0 + 8])
                for c, t in zip(acc, tiles):
                    c[..., n0:n0 + 8] = t
        return finish(acc).reshape(bsz, h, cout).astype(np.float64)

    def group_norm(y):
        yg = y.reshape(bsz, h, groups, cout // groups)
        mean = yg.mean(axis=(1, 3), keepdims=True)
        var = ((yg - mean) ** 2).mean(axis=(1, 3), keepdims=True)
        return (yg - mean) / np.sqrt(var + 1e-5)

    exact = group_norm(np.einsum("bmk,kc->bmc", a.astype(np.float64), wk.astype(np.float64))
                       .reshape(bsz, h, cout))
    three = np.abs(group_norm(product(mma_3xtf32, sum_3xtf32)) - exact).max()
    one_step = lambda c3, x_, w_: (c3[0] + tf32_rna(x_) @ tf32_rna(w_),) + c3[1:]
    one = np.abs(group_norm(product(one_step, lambda c3: c3[0])) - exact).max()
    assert three < 1e-5 and one > 1e-4, (three, one)
    # cvt.rna: ties away from zero, and the result has 10 mantissa bits
    ties = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12], np.float32)
    np.testing.assert_array_equal(tf32_rna(ties), np.array([1 + 2 ** -10, -(1 + 2 ** -10), 1.0],
                                                           np.float32))
    assert not np.any(tf32_rna(x).view(np.uint32) & 0x1FFF)


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
    tall = torch.zeros((1, 300, 1)), torch.zeros((5, 1, 128))  # 19 x 16 tiles of one group
    with pytest.raises(ValueError, match="tiles per warp"):
        conv.kernel(*tall, *(torch.zeros(128),) * 3, 1)
    assert (conv.launches, conv.plain_calls) == (0, 0)
    with pytest.raises(ValueError, match="multiple of n_groups"):  # the plain path checks too
        conv(x, w, b, g, be, 3)


def test_conv_launch_counts_only_in__launch(monkeypatch):
    """``kernel`` checks, allocates and hands its prepared tensors to
    ``_launch``, the one place a launch is counted (what chip_smoke.py's
    phase 18 captures into a CUDA graph); ``_launch`` refuses CPU tensors
    before it reads any library."""
    (x, w, b, g, be, pb), groups = _inputs((2, 8, 4, 16))
    args, pb = _torch([x, w, b, g, be]), torch.from_numpy(pb)
    conv = FusedConv1dGnMish()
    signature, seen = inspect.signature(FusedConv1dGnMish._launch), []
    conv._launch = lambda *a, **kw: seen.append(signature.bind(conv, *a, **kw).arguments)
    out = conv.kernel(*args, groups, pb, 1e-3)
    (got,) = seen
    assert got["x"] is args[0] and got["w"] is args[1] and got["pre_bias"] is pb
    assert got["out"] is out and tuple(out.shape) == (2, 8, 16) and out.dtype == torch.float32
    assert (got["n_groups"], got["eps"]) == (groups, 1e-3)
    del conv._launch
    asked = []
    monkeypatch.setattr(port_fused_conv, "_kernel_lib", lambda: asked.append(1))
    with pytest.raises(ValueError, match="CUDA"):
        conv._launch(*args, pb, out, groups, 1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        conv.kernel(*args, groups, None)
    assert asked == [] and (conv.launches, conv.plain_calls) == (0, 0)
    # the count is taken in _launch and nowhere else in the wrapper
    assert inspect.getsource(FusedConv1dGnMish).count("self.launches += 1") == 1
    assert "self.launches += 1" in inspect.getsource(FusedConv1dGnMish._launch)


def test_conv_profile_marks_the_committed_kernel(tmp_path):
    """scripts/conv_profile.py's copy: each substitution finds its line in
    the committed ``fused_conv.cu`` once (it raises otherwise), the other
    sources are copied unchanged, and the copy launches through
    ``FusedConv1dGnMish._launch`` with itself as ``lib``, which refuses CPU
    tensors before it reads any library."""
    from mpc_via_diffusion_model_tpu_torch.ops import _build
    from mpc_via_diffusion_model_tpu_torch.scripts import conv_profile
    conv_profile.instrument(_build.CSRC, tmp_path / "csrc")
    got = (tmp_path / "csrc" / "fused_conv.cu").read_text()
    assert all(got.count(f"MARK({i});") == 1 for i in range(8))
    assert "int conv_profile_read(" in got and "conv_profile_empty_launch(" in got
    for src in _build.CSRC.iterdir():
        if src.name != "fused_conv.cu":
            assert (tmp_path / "csrc" / src.name).read_bytes() == src.read_bytes()
    (x, w, b, g, be, _), groups = _inputs((2, 8, 4, 16))
    args, out = tuple(_torch([x, w, b, g, be])) + (groups,), torch.empty((2, 8, 16))
    conv, stub, seen = FusedConv1dGnMish(), object(), []
    signature = inspect.signature(FusedConv1dGnMish._launch)
    conv._launch = lambda *a, **kw: seen.append(signature.bind(conv, *a, **kw).arguments)
    conv_profile.launch_copy(conv, stub, args, out)
    (bound,) = seen
    assert bound["lib"] is stub and bound["out"] is out and bound["pre_bias"] is None
    assert bound["x"] is args[0] and bound["n_groups"] == groups
    del conv._launch
    with pytest.raises(ValueError, match="CUDA"):
        conv_profile.launch_copy(conv, stub, args, out)
    assert conv.launches == 0


@pytest.mark.gpu
def test_fused_conv_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version on the card at the six
    shapes and the ragged ones, with and without pre_bias, through the
    wrapper and through ``_launch`` on a prepared output: 1e-4,
    chip_smoke.py's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    conv = FusedConv1dGnMish()
    cases = [(_inputs(shape, seed=5)) for shape in SHAPES]
    for bsz, h, cin, cout, groups in RAGGED:
        rng = np.random.RandomState(9)
        f = lambda *s: rng.randn(*s).astype(np.float32)
        cases.append(((f(bsz, h, cin), f(5, cin, cout) * np.float32(0.3), f(cout), f(cout),
                       f(cout), f(bsz, cin)), groups))
    for (x, w, b, g, be, pb), groups in cases:
        args = [t.cuda() for t in _torch([x, w, b, g, be])]
        for p in (None, torch.from_numpy(pb).cuda()):
            got = conv(*args, groups, p)
            torch.testing.assert_close(got, conv.plain(*args, groups, p), atol=1e-4, rtol=1e-4)
            out = torch.full_like(got, float("nan"))
            conv._launch(*args, p, out, groups, 1e-5)
            torch.testing.assert_close(out, got, atol=0.0, rtol=0.0)
    assert conv.launches == 4 * len(cases)
