"""Schedules, normalizers, the cart-pole plant and cost, and the device
policy of the PyTorch port against the JAX package. Inputs come from
numpy seeds; both sides compute in fp32 with the same formula, so the
tolerances are a few fp32 ulps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.core import schedules as jax_sched
from mpc_via_diffusion_model_tpu.data import normalization as jax_norm
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu_torch.core import schedules as sched
from mpc_via_diffusion_model_tpu_torch.data import NormalizerStats, normalize, unnormalize
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_cost,
                                                        cartpole_virtual_swingup,
                                                        theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.utils import resolve_device

TABLES = ["betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
          "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
          "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2"]


@pytest.mark.parametrize("name", sorted(sched.BETA_SCHEDULES))
def test_schedule_tables_match_jax(name):
    """Both compute in float64 numpy and cast to float32: bit-equal."""
    got, want = sched.make_schedule(name, 25), jax_sched.make_schedule(name, 25)
    assert got.n_steps == want.n_steps
    for table in TABLES:
        np.testing.assert_array_equal(getattr(got, table).numpy(), np.asarray(getattr(want, table)),
                                      err_msg=f"{name}.{table}")


def test_exponential_schedule_keeps_quirks():
    s = sched.make_schedule("exponential", 25)
    assert s.betas[-1].item() == pytest.approx(1.0)  # linspace(0, n, n) reaches beta_end
    assert s.alphas_cumprod[-1].item() == pytest.approx(1e-12)  # the floor
    # the first chain step's coefficients are both 1e6 (t = 24)
    assert s.sqrt_recip_alphas_cumprod[24].item() == pytest.approx(1e6, rel=1e-6)
    assert s.sqrt_recipm1_alphas_cumprod[24].item() == pytest.approx(1e6, rel=1e-6)
    with pytest.raises(ValueError):
        sched.make_schedule("nope", 5)


def _stats_pair(kind, rng):
    mins = rng.uniform(-5, -1, 3).astype(np.float32)
    maxs = rng.uniform(1, 5, 3).astype(np.float32)
    means = rng.randn(3).astype(np.float32)
    stds = rng.uniform(0.5, 2, 3).astype(np.float32)
    port = NormalizerStats(kind, *(torch.from_numpy(a) for a in (mins, maxs, means, stds)))
    ref = jax_norm.NormalizerStats(kind, *(jnp.asarray(a) for a in (mins, maxs, means, stds)))
    return port, ref


@pytest.mark.parametrize("kind", ["limits", "gaussian", "identity"])
def test_normalize_unnormalize_match_jax(kind):
    rng = np.random.RandomState(0)
    port, ref = _stats_pair(kind, rng)
    x = (rng.randn(40, 3) * 4).astype(np.float32)  # past the limits too
    np.testing.assert_allclose(normalize(port, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_norm.normalize(ref, jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    y = (rng.randn(40, 3) * 1.5).astype(np.float32)
    got = unnormalize(port, torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_norm.unnormalize(ref, jnp.asarray(y))),
                               rtol=1e-6, atol=1e-6)
    if kind == "limits":  # clipped to [-1, 1] first: saturates at the limits
        assert np.all(got >= port.mins.numpy() - 1e-6) and np.all(got <= port.maxs.numpy() + 1e-6)


def test_cartpole_rollout_matches_jax():
    """100 Euler steps from random states under random controls."""
    rng = np.random.RandomState(1)
    port, ref = cartpole_virtual_swingup(), jax_cp.cartpole_virtual_swingup()
    assert (port.state_dim, port.control_dim, port.dt) == (ref.state_dim, ref.control_dim, ref.dt)
    for _ in range(3):
        x = rng.randn(5).astype(np.float32)
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
        for _ in range(100):
            u = (rng.randn(1) * 10).astype(np.float32)
            xt, xj = port.step(xt, torch.from_numpy(u)), ref.step(xj, jnp.asarray(u))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-5)


def test_cartpole_cost_matches_jax():
    rng = np.random.RandomState(2)
    port, ref = cartpole_virtual_cost(), jax_cp.cartpole_virtual_cost()
    for _ in range(5):
        x, u = rng.randn(5).astype(np.float32), rng.randn(1).astype(np.float32)
        np.testing.assert_allclose(port.stage(torch.from_numpy(x), torch.from_numpy(u)).item(),
                                   float(ref.stage(jnp.asarray(x), jnp.asarray(u))), rtol=1e-6)
        np.testing.assert_allclose(port.terminal(torch.from_numpy(x)).item(),
                                   float(ref.terminal(jnp.asarray(x))), rtol=1e-6)


def test_theta_to_red_theta_matches_jax():
    for theta in (0.0, 1.0, 3.0, np.pi, 5.5):
        assert theta_to_red_theta(theta) == pytest.approx(float(jax_cp.theta_to_red_theta(theta)), abs=1e-6)
    t = torch.tensor([0.0, 3.0, 2 * np.pi])
    np.testing.assert_allclose(theta_to_red_theta(t).numpy(), [0.0, theta_to_red_theta(3.0), 0.0],
                               atol=1e-6)


def test_device_policy():
    """cpu on request; cuda by default, which raises without a card. TF32 is
    off afterwards either way."""
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
