"""The port's losses and the training half of its GaussianDiffusion against
the JAX package, on the CPU: ``weighted_l1``/``weighted_l2``, ``q_sample``,
``predict_start_from_noise``/``predict_noise_from_start``,
``p_mean_variance`` (clip on and off, epsilon and x0 prediction),
``apply_hard_conds``, and ``loss`` on the JAX package's own draws,
re-derived from its key (l1, l2, without a context, x0 prediction).

Inputs are made with numpy from a seed. The denoiser is a fixed smooth
function of (x, t, context, mask) written once for each side, so that the
diffusion's own arithmetic is what is compared. Tolerance 1e-6: both sides
compute the same float32 formulas; XLA may fuse a multiply-add.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.core.losses import LOSSES as JAX_LOSSES
from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_schedule
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.diffusion.gaussian_diffusion import (
    apply_hard_conds as jax_apply_hard_conds)
from mpc_via_diffusion_model_tpu_torch.core import LOSSES, make_schedule, weighted_l1, weighted_l2
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.diffusion.gaussian_diffusion import apply_hard_conds

torch.set_num_threads(1)

T, B, H, D, C = 25, 16, 8, 2, 4
TOL = 1e-6


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.uniform(-1.2, 1.2, (B, H, D)).astype(np.float32),
            "noise": rng.randn(B, H, D).astype(np.float32),
            "t": rng.randint(0, T, B).astype(np.int64),
            "ctx": rng.randn(B, C).astype(np.float32),
            "mask": (rng.rand(B, 1) < 0.5).astype(np.float32),
            "w": rng.uniform(0, 2, (B, H, D)).astype(np.float32)}


def _jax_denoise(x, t, c, m):
    out = jnp.tanh(0.7 * x + t.astype(jnp.float32)[:, None, None] / T)
    if c is not None:
        c = c if m is None else c * (1.0 - m)
        out = out + 0.1 * jnp.sum(c, axis=-1)[:, None, None]
    return out


def _port_denoise(x, t, c, m):
    out = torch.tanh(0.7 * x + t.to(torch.float32)[:, None, None] / T)
    if c is not None:
        c = c if m is None else c * (1.0 - m)
        out = out + 0.1 * torch.sum(c, dim=-1)[:, None, None]
    return out


def _pair(**kw):
    return (GaussianDiffusion(make_schedule("exponential", T), **kw),
            JaxDiffusion(jax_schedule("exponential", T), **kw))


@pytest.mark.parametrize("name", ["l1", "l2"])
@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_losses_match_jax(name, weighted):
    a = _arrays()
    w = a["w"] if weighted else None
    got = LOSSES[name](torch.from_numpy(a["x"]), torch.from_numpy(a["noise"]),
                       None if w is None else torch.from_numpy(w))
    want = JAX_LOSSES[name](jnp.asarray(a["x"]), jnp.asarray(a["noise"]),
                            None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    assert LOSSES["l1"] is weighted_l1 and LOSSES["l2"] is weighted_l2 and set(LOSSES) == set(JAX_LOSSES)


def test_defaults_and_q_sample_match_jax():
    d, jd = _pair()
    assert (d.predict_epsilon, d.clip_denoised, d.loss_type, d.drop_prob) == (
        jd.predict_epsilon, jd.clip_denoised, jd.loss_type, jd.drop_prob) == (True, True, "l2", 0.25)
    a = _arrays(1)
    got = d.q_sample(torch.from_numpy(a["x"]), torch.from_numpy(a["t"]), torch.from_numpy(a["noise"]))
    want = jd.q_sample(jnp.asarray(a["x"]), jnp.asarray(a["t"]), jnp.asarray(a["noise"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    moved = d.to("cpu")
    assert moved.schedule.n_steps == T and torch.equal(moved.schedule.betas, d.schedule.betas)


@pytest.mark.parametrize("predict_epsilon", [True, False])
@pytest.mark.parametrize("clip_denoised", [True, False])
def test_p_mean_variance_and_predictions_match_jax(predict_epsilon, clip_denoised):
    d, jd = _pair(predict_epsilon=predict_epsilon, clip_denoised=clip_denoised)
    a = _arrays(2)
    x, t, ctx = (torch.from_numpy(a[k]) for k in ("x", "t", "ctx"))
    jx, jt_, jctx = (jnp.asarray(a[k]) for k in ("x", "t", "ctx"))
    # scaled so that clipping x0 to [-1, 1] matters
    scale = lambda f: (lambda *args: 3.0 * f(*args))
    mean, log_var = d.p_mean_variance(scale(_port_denoise), x, t, ctx)
    jmean, jlog_var = jd.p_mean_variance(scale(_jax_denoise), jx, jt_, jctx)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(log_var.numpy(), np.asarray(jlog_var), rtol=TOL, atol=TOL)
    model_out = torch.from_numpy(a["noise"])
    for fn in ("predict_start_from_noise", "predict_noise_from_start"):
        got = getattr(d, fn)(x, t, model_out)
        want = getattr(jd, fn)(jx, jt_, jnp.asarray(a["noise"]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=fn)


def test_apply_hard_conds_matches_jax():
    a = _arrays(3)
    idx = np.array([0, 5], np.int64)
    values = np.random.RandomState(4).randn(B, 2, D).astype(np.float32)
    x = torch.from_numpy(a["x"])
    got = apply_hard_conds(x, (torch.from_numpy(idx), torch.from_numpy(values)))
    want = jax_apply_hard_conds(jnp.asarray(a["x"]), (jnp.asarray(idx), jnp.asarray(values)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(x, torch.from_numpy(a["x"]))  # the input is left as it was
    assert apply_hard_conds(x, None) is x


@pytest.mark.parametrize("case", ["l2", "l1", "no_context", "x0"])
def test_loss_matches_jax_on_its_own_draws(case):
    """GaussianDiffusion.loss(key) of the JAX package against the port's
    loss on the draws re-derived from that key: t = randint(k_t), noise =
    normal(k_noise), mask = bernoulli(k_mask, drop_prob) (no mask without
    a context), for three keys."""
    kw = {"l1": dict(loss_type="l1"), "x0": dict(predict_epsilon=False)}.get(case, {})
    d, jd = _pair(**kw)
    a = _arrays(5)
    with_ctx = case != "no_context"
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jd.loss(_jax_denoise, jnp.asarray(a["x"]),
                       jnp.asarray(a["ctx"]) if with_ctx else None, key)
        k_t, k_noise, k_mask = jax.random.split(key, 3)
        t = np.asarray(jax.random.randint(k_t, (B,), 0, T)).astype(np.int64)
        noise = np.asarray(jax.random.normal(k_noise, (B, H, D), jnp.float32))
        mask = np.asarray(jax.random.bernoulli(k_mask, 0.25, (B, 1))).astype(np.float32)
        got = d.loss(_port_denoise, torch.from_numpy(a["x"]),
                     torch.from_numpy(a["ctx"]) if with_ctx else None, torch.from_numpy(t),
                     torch.from_numpy(noise), torch.from_numpy(mask) if with_ctx else None)
        np.testing.assert_allclose(float(got), float(want), rtol=TOL)


def test_loss_draws_from_a_generator():
    """Without staged draws the loss draws t, noise and (with a context)
    the mask from its generator in that order: a replay of the seed gives
    the same loss, the mask's share of dropped rows is about drop_prob, and
    without a context no mask is drawn."""
    d = GaussianDiffusion(make_schedule("exponential", T))
    a = _arrays(6)
    x, ctx = torch.from_numpy(a["x"]), torch.from_numpy(a["ctx"])
    seen = {}

    def spy(x_, t_, c_, m_):
        seen.update(t=t_, m=m_)
        return _port_denoise(x_, t_, c_, m_)

    losses = [float(d.loss(spy, x, ctx, generator=torch.Generator().manual_seed(9))) for _ in range(2)]
    assert losses[0] == losses[1]
    gen = torch.Generator().manual_seed(9)
    t = torch.randint(0, T, (B,), generator=gen)
    noise = torch.randn(x.shape, generator=gen)
    mask = (torch.rand((B, 1), generator=gen) < 0.25).float()
    assert torch.equal(seen["t"], t) and torch.equal(seen["m"], mask)
    assert float(d.loss(_port_denoise, x, ctx, t, noise, mask)) == losses[0]
    big = torch.zeros((4096, H, D))
    d.loss(spy, big, torch.zeros((4096, C)), generator=torch.Generator().manual_seed(1))
    assert abs(seen["m"].mean().item() - 0.25) < 0.02
    gen_a, gen_b = torch.Generator().manual_seed(2), torch.Generator().manual_seed(2)
    d.loss(spy, x, None, generator=gen_a)
    assert seen["m"] is None
    torch.randint(0, T, (B,), generator=gen_b)
    torch.randn(x.shape, generator=gen_b)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
