"""The port's CFG chain (ops/fused_denoise.py) and its weight packing
(ops/unet_pack.py) against the JAX package.

Tolerances. One chain is 30 sequential U-Net passes in fp32, summed in
another order than XLA's, so results agree to about 1e-6 and are held to
1e-4, the JAX suite's tolerance for chains and loops
(tests/test_fused_episode.py:59). The first step multiplies by
sqrt_recip_alphas_cumprod = sqrt_recipm1_alphas_cumprod = 1e6 (the
alphas_cumprod floor) and clips right after, so only elements with
|x - eps| below about 1e-6 could differ there; the seeds here have none.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.ops.fused_denoise import make_fused_cfg_chain as jax_fused_chain
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.models import load_flagship
from mpc_via_diffusion_model_tpu_torch.ops import unet_pack as up
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import make_fused_cfg_chain
from torch_port_util import emulate_cfg_chain_kernel, small_models

FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts" / "flagship" / "ema_params.pkl"
T, N_TAIL, W = 25, 5, 0.01
TOL = 1e-4


@pytest.fixture(scope="module")
def small():
    return small_models(seed=11)


@pytest.fixture(scope="module")
def flagship():
    return load_flagship(FLAGSHIP, device="cpu")


def _jax_noise(seed: int, n_samples: int, horizon: int) -> np.ndarray:
    """The draw both JAX samplers make inside themselves from this key."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      (T + N_TAIL + 1, n_samples, horizon, 1), jnp.float32))


def test_unet_pack_segments_match_module(flagship):
    """Every packed segment is its module parameter in the flax layout, at
    the offset the meta table gives the kernel."""
    packed = up.pack_unet(flagship, "cpu")
    W = packed.weights.numpy()
    m = packed.meta.numpy()
    seen = 0
    for name, (off, shape) in packed.segments.items():
        assert off % 4 == 0
        got = W[off:off + int(np.prod(shape))].reshape(shape)
        kind, field = name.split(".")
        if kind == "films":  # FiLM Dense of each block, zero-padded to max_c channels
            res = flagship.res_blocks()
            assert m[up.M_FW if field == "w" else up.M_FB] == off
            for r, rb in enumerate(res):
                lin = rb.cond_mlp[1]
                want = lin.weight.detach().numpy().T if field == "w" else lin.bias.detach().numpy()
                np.testing.assert_array_equal(got[r][..., :lin.out_features], want, err_msg=name)
                assert not got[r][..., lin.out_features:].any()
            continue
        seen += int(np.prod(shape))
        if kind.startswith("res"):
            rb = flagship.res_blocks()[int(kind[3:])]
            conv = {"w1": rb.blocks[0].block[0], "w2": rb.blocks[1].block[0]}
            tensor = {
                "b1": rb.blocks[0].block[0].bias, "g1": rb.blocks[0].block[2].weight,
                "be1": rb.blocks[0].block[2].bias, "b2": rb.blocks[1].block[0].bias,
                "g2": rb.blocks[1].block[2].weight, "be2": rb.blocks[1].block[2].bias,
            }
            if field in conv:
                want = conv[field].weight.detach().numpy().transpose(2, 1, 0)
            elif field == "wr":
                want = rb.residual_conv.weight.detach().numpy()[:, :, 0].T
            elif field == "br":
                want = rb.residual_conv.bias.detach().numpy()
            else:
                want = tensor[field].detach().numpy()
            base = up.M_RES + int(kind[3:]) * up.RES_STRIDE
            idx = {"w1": up.R_W1, "b1": up.R_B1, "g1": up.R_G1, "be1": up.R_BE1, "w2": up.R_W2,
                   "b2": up.R_B2, "g2": up.R_G2, "be2": up.R_BE2, "wr": up.R_WR, "br": up.R_BR}
            assert m[base + idx[field]] == off
        elif kind.startswith("down"):
            conv = flagship.downs[int(kind[4:])][4].conv
            want = (conv.weight.detach().numpy().transpose(2, 1, 0) if field == "w"
                    else conv.bias.detach().numpy())
            assert m[up.M_DOWN + 2 * int(kind[4:]) + (field == "b")] == off
        elif kind.startswith("up"):
            conv = flagship.ups[int(kind[2:])][4].conv
            # the flax kernel: torch's ConvTranspose1d weight un-flipped along k
            want = (conv.weight.detach().numpy()[:, :, ::-1].transpose(2, 0, 1) if field == "w"
                    else conv.bias.detach().numpy())
            assert m[up.M_UP + 2 * int(kind[2:]) + (field == "b")] == off
        elif kind == "final":
            blk = flagship.final_conv[0].block
            want = {"w": blk[0].weight.detach().numpy().transpose(2, 1, 0),
                    "b": blk[0].bias.detach().numpy(), "g": blk[2].weight.detach().numpy(),
                    "be": blk[2].bias.detach().numpy()}[field]
            assert m[up.M_FIN + ["w", "b", "g", "be"].index(field)] == off
        else:
            conv = flagship.final_conv[1]
            want = (conv.weight.detach().numpy()[:, :, 0].T if field == "w"
                    else conv.bias.detach().numpy())
            assert m[up.M_F1 + (field == "b")] == off
        np.testing.assert_array_equal(got, want, err_msg=name)
    # every conv-backbone parameter is packed once, beside the FiLM Dense
    # weights checked above (the time MLP is not packed)
    backbone = sum(p.numel() for n, p in flagship.named_parameters()
                   if "cond_mlp" not in n and "time_mlp" not in n)
    assert seen == backbone
    assert m[up.M_NRES] == 12 and m[up.M_MAXC] == 128
    assert (m[up.M_COND], m[up.M_TEMB], m[up.M_CTX]) == (38, 32, 5)
    assert list(m[up.M_DIMS:up.M_DIMS + 4]) == [1, 32, 64, 128]
    assert packed.smem_bytes <= up.SMEM_LIMIT


@pytest.mark.parametrize("which", ["small", "flagship"])
def test_kernel_program_emulation_matches_plain(which, small, flagship):
    """The kernel's op program, run in numpy on the packed buffer and the
    meta table, equals the plain chain: the layout the kernel reads is
    right, so the CUDA kernel can only be wrong in its arithmetic."""
    model = small[2] if which == "small" else flagship
    chain = make_fused_cfg_chain(model, make_schedule("exponential", T), n_samples=2, w=W,
                                 n_tail=N_TAIL, device="cpu")
    rng = np.random.RandomState(5)
    h = model.n_support_points
    ctx = torch.from_numpy(rng.randn(2, 5).astype(np.float32))
    noise = torch.from_numpy(rng.randn(T + N_TAIL + 1, 2, h, 1).astype(np.float32))
    want = chain.plain(ctx, noise).numpy()
    with torch.no_grad():
        films = chain.films(ctx).numpy()
    noise_tab = torch.cat([noise[1:], noise[:1]]).numpy()
    got = emulate_cfg_chain_kernel(chain.packed, films, noise_tab, chain.coefs.numpy(), W)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_plain_chain_matches_jax_fused_chain_interpret(small):
    """Plain chain against the Pallas chain kernel in interpret mode, with
    the kernel's own noise draw handed over."""
    jm, params, tm = small
    ctx = np.random.RandomState(1).randn(1, 5).astype(np.float32)
    want = jax_fused_chain(jm, params, jax_make_schedule("exponential", T), n_samples=1, w=W,
                           n_diffusion_steps_without_noise=N_TAIL, interpret=True)(
        jnp.asarray(ctx), jax.random.PRNGKey(3))
    chain = make_fused_cfg_chain(tm, make_schedule("exponential", T), n_samples=1, w=W,
                                 n_tail=N_TAIL, device="cpu")
    got = chain(torch.from_numpy(ctx), torch.from_numpy(_jax_noise(3, 1, 16)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("n_samples,w", [(1, 0.01), (3, 1.5)])
def test_plain_chain_matches_jax_ddpm_cfg_sample(small, n_samples, w):
    jm, params, tm = small
    ctx = np.random.RandomState(2).randn(n_samples, 5).astype(np.float32)
    jd = JaxDiffusion(schedule=jax_make_schedule("exponential", T))
    want = jd.ddpm_cfg_sample(lambda x, t, c, m: jm.apply(params, x, t, c, m),
                              (n_samples, 16, 1), jax.random.PRNGKey(7), jnp.asarray(ctx), w=w,
                              n_diffusion_steps_without_noise=N_TAIL)
    chain = make_fused_cfg_chain(tm, make_schedule("exponential", T), n_samples=n_samples, w=w,
                                 n_tail=N_TAIL, device="cpu")
    got = chain(torch.from_numpy(ctx), torch.from_numpy(_jax_noise(7, n_samples, 16)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_port_ddpm_cfg_sample_matches_jax(small):
    """The port's GaussianDiffusion.ddpm_cfg_sample, the replan's sampler
    without an override, against the JAX package's."""
    jm, params, tm = small
    ctx = np.random.RandomState(4).randn(2, 5).astype(np.float32)
    jd = JaxDiffusion(schedule=jax_make_schedule("exponential", T))
    want = jd.ddpm_cfg_sample(lambda x, t, c, m: jm.apply(params, x, t, c, m), (2, 16, 1),
                              jax.random.PRNGKey(9), jnp.asarray(ctx), w=W,
                              n_diffusion_steps_without_noise=N_TAIL)
    got = GaussianDiffusion(make_schedule("exponential", T)).ddpm_cfg_sample(
        tm, (2, 16, 1), torch.from_numpy(ctx), w=W, n_diffusion_steps_without_noise=N_TAIL,
        noise=torch.from_numpy(_jax_noise(9, 2, 16)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_chain_wrapper_runs_plain_version_on_cpu(small):
    chain = make_fused_cfg_chain(small[2], make_schedule("exponential", T), device="cpu")
    rng = np.random.RandomState(0)
    ctx = torch.from_numpy(rng.randn(1, 5).astype(np.float32))
    noise = torch.from_numpy(rng.randn(T + N_TAIL + 1, 1, 16, 1).astype(np.float32))
    out = chain(ctx, noise)
    assert out.shape == (1, 16, 1) and torch.isfinite(out).all()
    assert (chain.launches, chain.plain_calls) == (0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        chain.kernel(ctx, noise)  # a CPU tensor never reaches the kernel
    with pytest.raises(ValueError, match="noise must be"):
        chain(ctx, noise[:-1])
    with pytest.raises(ValueError, match="context must be"):
        chain(ctx[:, :4], noise)


@pytest.mark.gpu
def test_cfg_chain_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version on the card, at the
    flagship's full width. The plain version runs cuDNN convolutions in
    fp32 (TF32 off), the kernel FMA loops: sums in other orders, 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    chain = make_fused_cfg_chain(load_flagship(FLAGSHIP, device="cuda"),
                                 make_schedule("exponential", T), n_samples=2, w=W,
                                 n_tail=N_TAIL, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ctx = torch.randn((2, 5), generator=gen, device="cuda")
    noise = torch.randn((T + N_TAIL + 1, 2, 32, 1), generator=gen, device="cuda")
    got = chain(ctx, noise)
    torch.cuda.synchronize()
    want = chain.plain(ctx, noise)
    assert chain.launches == 1
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
