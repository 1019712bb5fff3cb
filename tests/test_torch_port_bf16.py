"""bf16 weights in the port's CFG chain and CFG episode (``weights_dtype``,
``bench.py``'s ``BENCH_BF16``) against the JAX package's bf16 kernels.

With ``weights_dtype=jnp.bfloat16`` the JAX kernels store every conv kernel
in bf16 (``build_unet_ops``' ``push``, ``append_final_1x1``) and round each
product's activation operand to bf16 before an fp32 dot
(mpc_via_diffusion_model_tpu/ops/fused_unet.py:108, :279, :313; the final
1x1 conv at fused_denoise.py:106 and fused_episode.py:587). The port's plain
version is ``models/bf16.py::bf16_conv_copy``; its kernels' programs are the
numpy emulators of ``torch_port_util`` with the bf16 buffer.

Tolerances. A rounding point that both sides take alike leaves only fp32
sums in other orders (about 1e-7 per pass). But an activation whose fp32
value lies within that difference of a midpoint between two bf16 numbers
rounds one way on one side and the other way on the other. One such flip
moved a pass's output by up to 7e-3 in the small U-Net here (GroupNorm
groups one channel wide), about 1e-4 at the flagship's widths, and over a
30-step chain flips cascade until two correct bf16 versions part by about
as much as bf16 parts from fp32 (the flagship at T = 25 + 5: 1.1e-3 median
over 64 samples, plain fp32 against float64). The chains and episodes here
are short (T = 10 + 2) and held to JAX's at 1e-3 (1.1e-4 measured on the
chain). The tight check of the rounding points is the chain's emulated
program against its plain version with both in float64, where no rounding
depends on the order of a sum: 8e-9 apart, while leaving out the final
1x1 conv's rounding moved them by 4.5e-4 (every operand's: 1.6e-3;
truncating instead of rounding: 3.9e-3). In float32 the emulated
programs are held to 1e-3, where a flip reached 1.5e-4.
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu.ops.fused_denoise import make_fused_cfg_chain as jax_fused_chain
from mpc_via_diffusion_model_tpu.ops.fused_episode import make_fused_cfg_episode as jax_episode
from mpc_via_diffusion_model_tpu.ops.fused_unet import append_final_1x1, build_unet_ops
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import NormalizerStats
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_collect_cost,
                                                        cartpole_virtual_cost,
                                                        cartpole_virtual_swingup,
                                                        theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.models import TemporalUnet, from_flax_params, load_flagship
from mpc_via_diffusion_model_tpu_torch.models.bf16 import bf16_conv_copy, round_bf16
from mpc_via_diffusion_model_tpu_torch.models.layers import mish
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import (make_fused_cfg_chain,
                                                                 make_fused_ddim_chain)
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import (make_fused_cfg_episode,
                                                                 make_fused_ddim_episode)
from torch_port_util import (bf16_rne, emulate_cfg_chain_kernel, emulate_cfg_episode_kernel,
                             randomize, small_models)

torch.set_num_threads(1)

FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts" / "flagship" / "ema_params.pkl"
T, N_TAIL, W = 10, 2, 0.01
TOL_JAX = 1e-3        # the port's plain bf16 versions against JAX's bf16 kernels
TOL_EMULATOR_F64 = 1e-6  # the chain's program against the plain bf16 chain, both in float64
BF16_VS_FP32 = 8e-2   # JAX's own bound of bf16 against fp32 (tests/test_fused_denoise.py:59-77)
X0 = np.array([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], np.float32)


@pytest.fixture(scope="module")
def small():
    return small_models(seed=11)


def _episode_models(seed: int = 31, horizon: int = 8):
    cfg = dict(state_dim=1, n_support_points=horizon, unet_input_dim=8, dim_mults=(1, 2),
               context_dim=5, cfg_indicator=True)
    jm = JaxUnet(conditioning_type="default", **cfg)
    params = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, horizon, 1)),
                                      jnp.zeros((1,), jnp.int32), jnp.zeros((1, 5)),
                                      jnp.zeros((1, 1))), seed)
    tm = TemporalUnet(**cfg)
    tm.load_state_dict(from_flax_params(params))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def flagship():
    return load_flagship(FLAGSHIP, device="cpu")


@pytest.fixture(scope="module")
def episode_models():
    return _episode_models()


def _stats(lib):
    if lib == "jax":
        return (JaxStats("limits", jnp.full((1,), -30.0), jnp.full((1,), 30.0)),
                JaxStats("limits", jnp.full((5,), -10.0), jnp.full((5,), 10.0)))
    return (NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0)),
            NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0)))


def _chain(tm, b, weights_dtype=torch.bfloat16, t=T, n_tail=N_TAIL, device="cpu"):
    return make_fused_cfg_chain(tm, make_schedule("exponential", t), n_samples=b, w=W,
                                n_tail=n_tail, weights_dtype=weights_dtype, device=device)


def _episode(tm, k=1, sel_h=None, n_steps=2, weights_dtype=torch.bfloat16, t=T, n_tail=N_TAIL,
             device="cpu"):
    ins, cs = _stats("torch")
    return make_fused_cfg_episode(tm, make_schedule("exponential", t), ins, cs,
                                  cartpole_virtual_swingup(), cartpole_virtual_cost(),
                                  n_steps=n_steps, w=W, n_diffusion_steps_without_noise=n_tail,
                                  n_candidates=k, selection_horizon=sel_h,
                                  weights_dtype=weights_dtype, device=device)


def _rounding_cases() -> np.ndarray:
    """Seeded values over many scales, the exact ties between two bf16
    numbers (even and odd lower neighbour, both signs), values just off a
    tie, the largest finite floats (which round to inf), subnormals and
    signed zeros."""
    rng = np.random.RandomState(0)
    seeded = (rng.randn(4096) * 10.0 ** rng.uniform(-30, 30, 4096)).astype(np.float32)
    base = rng.randint(0, 0x7F7F, 512).astype(np.uint32) << np.uint32(16)
    ties = base | np.uint32(0x8000)
    near = np.concatenate([ties - np.uint32(1), ties + np.uint32(1)])
    bits = np.concatenate([ties, ties | np.uint32(0x80000000), near]).view(np.float32)
    special = np.array([3.3895314e38, 3.3961776e38, 3.4028235e38, -3.4028235e38, 1e-40, -1e-42,
                        1.1754944e-38, 0.0, -0.0, 1.0, -1.0, 65504.0], np.float32)
    return np.concatenate([seeded, bits, special])


@pytest.mark.parametrize("rounding", ["port", "emulator"])
def test_bf16_rounding_equals_jax_astype_bit_for_bit(rounding):
    """``models/bf16.py::round_bf16`` (torch's conversion, as the wrappers
    round the packed buffer and the plain version its operands) and
    ``torch_port_util.bf16_rne`` (the add-and-mask the emulators use) against
    ``jnp.asarray(x).astype(jnp.bfloat16)``: round to nearest, ties to even."""
    x = _rounding_cases()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = round_bf16(torch.from_numpy(x)).numpy() if rounding == "port" else bf16_rne(x)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isinf(got[-10]) and not np.isinf(got[-12])  # the float max rounds up to inf


def _flax_layout(buf: torch.Tensor, packed, name: str, n_ranks: int) -> torch.Tensor:
    """Segment ``name`` of the kernel's buffer ``buf`` in the flax layout:
    a conv kernel of the body back from rank-major (n, rows, cout / n)."""
    off, shape = packed.segments[name]
    n = int(np.prod(shape))
    seg = buf[off:off + n]
    if name == "final1x1.w":  # not split over the cluster: stored as it is
        return seg.view(shape)
    cout = shape[-1]
    return seg.view(n_ranks, n // cout, cout // n_ranks).transpose(0, 1).reshape(shape)


def test_bf16_conv_kernels_equal_jax_flat_arrays(small):
    """Every conv kernel the bf16 entries read from ``cluster.weights_bf16``
    equals, bit for bit and in its layout before the rank-major permutation,
    its array in ``build_unet_ops(..., jnp.bfloat16)["flat"]`` (and the final
    1x1 kernel ``append_final_1x1``'s); the fp32 buffer beside it keeps the
    biases and GroupNorm unrounded, as ``push_f32`` does."""
    jm, params, tm = small
    chain = _chain(tm, 1)
    ops = build_unet_ops(jm, params, 2, jnp.bfloat16)
    flat = list(ops["flat"])
    append_final_1x1(flat, ops["final_1x1"], jnp.bfloat16)
    bf16_arrays = [a for a in flat if a.dtype == jnp.bfloat16]
    names = []
    for r in range(ops["n_res"]):
        names += [f"res{r}.w1", f"res{r}.w2"] + ([f"res{r}.wr"] if f"res{r}.wr" in
                                                 chain.packed.segments else [])
    n_levels = len(ops["in_out"])
    names += [f"down{lvl}.w" for lvl in range(n_levels - 1)]
    names += [f"up{j}.w" for j in range(n_levels - 1)] + ["final.w"]
    buf = chain.cluster.weights_bf16
    assert buf.dtype == torch.bfloat16 and buf.shape == chain.cluster.weights.shape
    for name, want in zip(names, bf16_arrays):
        got = _flax_layout(buf, chain.packed, name, 8)
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(want).view(np.uint16), err_msg=name)
    got = _flax_layout(buf, chain.packed, "final1x1.w", 8)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(bf16_arrays[-1]).view(np.uint16))
    # the others (GroupNorm one-hots, batch selectors, resampling operators) are 0/1
    for a in bf16_arrays[len(names):-1]:
        assert set(np.unique(np.asarray(a, np.float32))) <= {0.0, 1.0}
    fp32 = chain.cluster.weights
    for name in ("res0.b1", "res0.g1", "final.be"):
        off, shape = chain.packed.segments[name]
        assert not torch.equal(fp32[off:off + shape[0]], round_bf16(fp32[off:off + shape[0]]))


@pytest.mark.parametrize("n_samples", [1, 2])
def test_plain_bf16_chain_matches_jax_chain_interpret(small, n_samples):
    """The plain bf16 chain against ``make_fused_cfg_chain(weights_dtype=
    jnp.bfloat16, interpret=True)``, with the JAX kernel's own draw."""
    jm, params, tm = small
    ctx = np.random.RandomState(n_samples).randn(n_samples, 5).astype(np.float32)
    key = jax.random.PRNGKey(5 + n_samples)
    want = jax_fused_chain(jm, params, jax_make_schedule("exponential", T), n_samples=n_samples,
                           w=W, n_diffusion_steps_without_noise=N_TAIL,
                           weights_dtype=jnp.bfloat16, interpret=True)(jnp.asarray(ctx), key)
    noise = np.array(jax.random.normal(key, (T + N_TAIL + 1, n_samples, 16, 1), jnp.float32))
    chain = _chain(tm, n_samples)
    got = chain(torch.from_numpy(ctx), torch.from_numpy(noise))
    assert (chain.launches, chain.plain_calls) == (0, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_JAX, rtol=0)


@pytest.mark.parametrize("k,sel_h,seed", [(1, None, 8), (2, 4, 4)])
def test_plain_bf16_episode_matches_jax_episode_interpret(episode_models, k, sel_h, seed):
    """The plain bf16 episode against the JAX episode kernel in bf16 in
    interpret mode, 2 replans, on the draws the JAX episode makes from each
    replan key: tracks and costs within the tolerance. The JAX kernel
    returns no choices; its controls are the chosen candidates' first
    controls, and the candidates' differ by more than a volt, so equal
    controls are equal choices. The keys give controls inside the limits
    (a clipped control would hide bf16) and, at K = 2, the second candidate
    at one replan and the first at the other."""
    jm, params, tm = episode_models
    ins, cs = _stats("jax")
    key, n_steps = jax.random.PRNGKey(seed), 2
    want = jax_episode(jm, params, jax_make_schedule("exponential", T), ins, cs,
                       jax_cp.cartpole_virtual_swingup(), jax_cp.cartpole_virtual_cost(),
                       n_steps=n_steps, w=W, n_diffusion_steps_without_noise=N_TAIL,
                       n_candidates=k, selection_horizon=sel_h, weights_dtype=jnp.bfloat16,
                       interpret=True)(jnp.asarray(X0), key)
    noise = np.stack([np.array(jax.random.normal(kk, (T + N_TAIL + 1, k, 8, 1), jnp.float32))
                      for kk in jax.random.split(key, n_steps)])
    ep = _episode(tm, k, sel_h, n_steps)
    got = ep.plain(torch.from_numpy(X0), torch.from_numpy(noise))
    fp32 = _episode(tm, k, sel_h, n_steps, torch.float32).plain(torch.from_numpy(X0),
                                                                torch.from_numpy(noise))
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL_JAX, atol=TOL_JAX,
                                   err_msg=name)
    assert got[1].abs().max() < 30.0 and (k == 1 or got[3].tolist() == [1, 0])
    assert (got[1] - fp32[1]).abs().max() > 1e-3  # bf16 is not the fp32 function


def test_plain_bf16_chain_within_jax_bound_of_fp32(small):
    """bf16 against fp32 on the same draw, within the JAX suite's 8e-2, and
    not equal to it: the plain version does round."""
    tm = small[2]
    rng = np.random.RandomState(4)
    ctx = torch.from_numpy(rng.randn(2, 5).astype(np.float32))
    noise = torch.from_numpy(rng.randn(T + N_TAIL + 1, 2, 16, 1).astype(np.float32))
    got = _chain(tm, 2)(ctx, noise)
    want = _chain(tm, 2, torch.float32)(ctx, noise)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=BF16_VS_FP32, rtol=0)
    assert (got - want).abs().max() > 1e-4


def test_bf16_copy_rounds_conv_weights_and_inputs_only(small):
    """``bf16_conv_copy``: every Conv1d and ConvTranspose1d kernel rounded
    and its input rounded; biases, GroupNorm, FiLM and the time MLP are the
    model's; the model itself is unchanged."""
    tm = small[2]
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    copy = bf16_conv_copy(tm)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    conv_weights = {n + ".weight" for n, m in tm.named_modules()
                    if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d))}
    assert len(conv_weights) == 35
    for k, v in copy.state_dict().items():
        want = round_bf16(before[k]) if k in conv_weights else before[k]
        assert torch.equal(v, want), k
    conv = copy.final_conv[1]
    x = torch.randn(2, 8, 16)
    with torch.no_grad():
        torch.testing.assert_close(conv(x), torch.nn.functional.conv1d(
            round_bf16(x), conv.weight, conv.bias), atol=0, rtol=0)


def _plain_chain_f64(chain, ctx: torch.Tensor, noise: torch.Tensor):
    """The plain bf16 chain (``chain.plain``'s steps on ``chain.plain_model``)
    in float64 from the fp32 conditioning vectors, and the FiLM table the
    kernel reads, (n_total, n_res, 2B, max_c), from the same vectors in
    float64."""
    model = copy.deepcopy(chain.plain_model).double()
    b = chain.n_samples
    ctx2 = torch.cat([ctx, ctx])
    mask2 = torch.cat([torch.zeros((b, 1)), torch.ones((b, 1))])
    wp1, w = float(np.float32(1.0 + chain.w)), float(np.float32(chain.w))
    x, films = noise[0].double(), []
    with torch.no_grad():
        for si in range(chain.n_total):
            sra, srm, c1, c2, sg = chain.coefs[si].double()
            c = chain.plain_model.conditioning(chain.t_eff[si].expand(2 * b), ctx2, mask2).double()
            films.append(torch.einsum("bc,rcd->rbd", mish(c), chain.packed.films_w.double())
                         + chain.packed.films_b.double()[:, None, :])
            x2 = torch.cat([x, x])
            y = model.features(x2, c)
            eps2 = model.final_conv[1](y.transpose(1, 2)).transpose(1, 2)
            recon2 = sra * x2 - srm * eps2
            recon = torch.clamp(wp1 * recon2[:b] - w * recon2[b:], -1.0, 1.0)
            x = c1 * recon + c2 * x + sg * noise[si + 1].double()
    return x.numpy(), torch.stack(films).numpy()


@pytest.mark.parametrize("b", [1, 2])
def test_bf16_chain_program_is_race_free_and_matches_plain(flagship, b):
    """cfg_chain.cu's bf16 instantiation emulated (``emulate_cfg_chain_kernel``
    with ``cluster.weights_bf16``: conv kernels from the bf16 copy, every
    operand rounded) on 8 NaN-filled images per sample, race-checked, on the
    flagship's weights at full width, 3 + 1 steps. In float64 against the
    plain bf16 chain in float64, so that both take every rounding alike and
    agree to about 1e-8 (float64's rounding through the first step's 1e6
    coefficients): a rounding point left out or taken otherwise moves the
    output by 1e-5 or more (bf16's whole effect here is about 1e-3). In float32,
    as the kernel runs, against the plain bf16 chain: within 1e-3, where a
    flipped rounding may reach 1.5e-4."""
    chain = _chain(flagship, b, t=3, n_tail=1)
    rng = np.random.RandomState(b)
    ctx = torch.from_numpy(rng.randn(b, 5).astype(np.float32))
    noise = torch.from_numpy(rng.randn(chain.n_total + 1, b, 32, 1).astype(np.float32))
    want, films = _plain_chain_f64(chain, ctx, noise)
    noise_tab = torch.cat([noise[1:], noise[:1]]).numpy()
    args = (chain.packed, chain.cluster.weights)
    got, barriers = emulate_cfg_chain_kernel(*args, films, noise_tab, chain.coefs.numpy(), W,
                                             weights_bf16=chain.cluster.weights_bf16,
                                             dtype=np.float64)
    np.testing.assert_allclose(got, want, atol=TOL_EMULATOR_F64, rtol=0)
    assert barriers == [2 + 29 * chain.n_total] * b
    with torch.no_grad():
        films32 = chain.films(ctx).numpy()
    got32, _ = emulate_cfg_chain_kernel(*args, films32, noise_tab, chain.coefs.numpy(), W,
                                        weights_bf16=chain.cluster.weights_bf16)
    np.testing.assert_allclose(got32, chain.plain(ctx, noise).numpy(), atol=TOL_JAX, rtol=0)
    fp32, _ = emulate_cfg_chain_kernel(*args, films32, noise_tab, chain.coefs.numpy(), W)
    assert np.abs(fp32 - got32).max() > 1e-4  # the emulated bf16 program is not the fp32 one


@pytest.mark.parametrize("k,sel_h", [(1, None), (3, 4)])
def test_bf16_episode_program_is_race_free_and_matches_plain(flagship, k, sel_h):
    """cfg_episode.cu's bf16 instantiation emulated on one cluster of 8
    NaN-filled images through 2 replans of 3 + 1 steps against the plain
    bf16 episode, on the flagship's weights at full width: controls in
    u_norm (over the limits' half-range, 30), states and costs within 1e-3,
    where a flipped rounding may reach 1.5e-4 (the chain's test above holds
    the rounding points of the body and the final 1x1 conv, which this
    program shares, in float64), choices equal."""
    n_steps = 2
    ep = _episode(flagship, k, sel_h, n_steps, t=3, n_tail=1)
    noise = torch.from_numpy(np.random.RandomState(k).randn(*ep.noise_shape).astype(np.float32))
    want = ep.plain(torch.from_numpy(X0), noise)
    noise_tab = torch.cat([noise[:, 1:], noise[:, :1]], dim=1).numpy()
    *got, _ = emulate_cfg_episode_kernel(ep.packed, ep.weights, ep.t_embs.numpy(), noise_tab,
                                         ep.coefs.numpy(), ep.consts.numpy(), X0, W, k,
                                         ep.selection_horizon, n_steps,
                                         weights_bf16=ep.cluster.weights_bf16)
    np.testing.assert_allclose(got[1] / 30.0, want[1].numpy() / 30.0, atol=TOL_JAX, rtol=0)
    for name, g, w_ in (("x_track", got[0], want[0]), ("stage_costs", got[2], want[2])):
        np.testing.assert_allclose(g, w_.numpy(), rtol=TOL_JAX, atol=TOL_JAX, err_msg=name)
    np.testing.assert_array_equal(got[3], want[3].numpy())


def test_builders_refuse_other_weight_types(small):
    """The CFG builders take float32 and bfloat16 only; the DDIM builders
    still take float32 only (their bf16 instantiations are not ported)."""
    tm = small[2]
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
            _chain(tm, 1, dtype)
        with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
            _episode(tm, weights_dtype=dtype)
    ins, cs = _stats("torch")
    sched = make_schedule("exponential", 25)
    with pytest.raises(NotImplementedError, match="float32 weights"):
        make_fused_ddim_chain(tm, sched, [23], weights_dtype=torch.bfloat16, device="cpu")
    with pytest.raises(NotImplementedError, match="float32 weights"):
        make_fused_ddim_episode(tm, sched, [23], ins, cs, cartpole_virtual_swingup(),
                                cartpole_virtual_collect_cost(), weights_dtype=torch.bfloat16,
                                device="cpu")
    chain, ep = _chain(tm, 1), _episode(tm)
    assert (chain.entry, ep.name) == ("cfg_chain_bf16", "cfg_episode_bf16")
    assert (_chain(tm, 1, torch.float32).entry, _episode(tm, weights_dtype=torch.float32).name) \
        == ("cfg_chain", "cfg_episode")
    with pytest.raises(ValueError, match="CUDA"):  # a CPU tensor never reaches the bf16 kernel
        chain.kernel(torch.zeros(1, 5), torch.zeros(chain.n_total + 1, 1, 16, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["chain", "episode_k1", "episode_k4"])
def test_bf16_kernels_match_plain_on_gpu(kernel):
    """The bf16 entries on the card at the flagship's full width against
    their plain bf16 versions, at one U-Net pass (T = 1, no tail), as
    chip_smoke.py gates them: over 64 samples (the chain, in one launch) or
    replans (the episode at K = 1; 8 at K = 4, choices equal) the per-sample
    max |kernel - plain| in u_norm at most 5e-6 at the median (an occasional
    flipped rounding moves a sample by up to ~1e-4) and 1e-3 at the worst."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    model = load_flagship(FLAGSHIP, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if kernel == "chain":
        chain = _chain(model, 64, t=1, n_tail=0, device="cuda")
        ctx = torch.randn((64, 5), generator=gen, device="cuda")
        noise = torch.randn((2, 64, 32, 1), generator=gen, device="cuda")
        got = chain(ctx, noise)
        torch.cuda.synchronize()
        assert chain.launches == 1
        want = chain.plain(ctx, noise)
    else:
        k, n_steps, sel_h = (1, 64, None) if kernel == "episode_k1" else (4, 8, 8)
        ep = _episode(model, k, sel_h, n_steps, t=1, n_tail=0, device="cuda")
        x0 = torch.from_numpy(X0).cuda()
        noise = torch.randn(ep.noise_shape, generator=gen, device="cuda")
        out = ep.kernel(x0, noise)
        torch.cuda.synchronize()
        assert ep.launches == 1
        ref = ep.plain(x0, noise)
        assert torch.equal(out[3], ref[3])
        got, want = out[1] / 30.0, ref[1] / 30.0
    per = (got - want).abs().flatten(1).max(dim=1).values
    assert per.median().item() <= 5e-6 and per.max().item() <= 1e-3
