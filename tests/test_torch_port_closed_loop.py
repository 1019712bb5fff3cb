"""The slice as a whole: the port's cart-pole CFG closed loop against the
JAX package's ``make_closed_loop`` with the Pallas chain kernel (interpret
mode) as its sampler, for 8 replans from x0 = [0, 0, 3.0, 0, theta*(3.0)].

The U-Net is the small one of torch_port_util (interpret mode is slow at
full width; tests/test_torch_port_models.py covers the full-width forward).
Normalizer statistics are bench.py's synthetic limits. Per-replan noise is
the draw the JAX chain makes from each key of ``jax.random.split``, handed
over as numpy. Tolerance 1e-4, the JAX suite's for closed loops
(tests/test_fused_episode.py:59): per-replan fp32 differences of ~1e-6 in
u_norm, times 30 after unnormalizing, pass through 8 plant steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.control import make_closed_loop as jax_closed_loop
from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu.ops.fused_denoise import make_fused_cfg_chain as jax_fused_chain
from mpc_via_diffusion_model_tpu_torch.control import make_closed_loop
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import NormalizerStats
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_cost,
                                                        cartpole_virtual_swingup,
                                                        theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import make_fused_cfg_chain
from torch_port_util import SMALL, small_models

T, N_TAIL, W, N_STEPS = 25, 5, 0.01, 8
H = SMALL["n_support_points"]
TOL = 1e-4


def _stats(lib, lo, hi, n):
    if lib == "jax":
        return JaxStats("limits", jnp.full((n,), lo), jnp.full((n,), hi))
    return NormalizerStats("limits", torch.full((n,), lo), torch.full((n,), hi))


@pytest.fixture(scope="module")
def setup():
    jm, params, tm = small_models(seed=21)
    x0 = np.array([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], np.float32)
    key = jax.random.PRNGKey(42)
    noise = np.stack([np.asarray(jax.random.normal(k, (T + N_TAIL + 1, 1, H, 1), jnp.float32))
                      for k in jax.random.split(key, N_STEPS)])
    return jm, params, tm, x0, key, noise


def _port_loop(tm, n_steps=N_STEPS, **kw):
    schedule = make_schedule("exponential", T)
    return make_closed_loop(GaussianDiffusion(schedule), tm, _stats("torch", -30.0, 30.0, 1),
                            _stats("torch", -10.0, 10.0, 5), cartpole_virtual_swingup(),
                            cartpole_virtual_cost(), horizon=H, n_steps=n_steps, w=W,
                            n_diffusion_steps_without_noise=N_TAIL, device="cpu", **kw)


def test_closed_loop_matches_jax_with_fused_chain(setup):
    jm, params, tm, x0, key, noise = setup
    schedule = jax_make_schedule("exponential", T)
    chain = jax_fused_chain(jm, params, schedule, n_samples=1, w=W,
                            n_diffusion_steps_without_noise=N_TAIL, interpret=True)
    loop = jax_closed_loop(JaxDiffusion(schedule=schedule), jm.apply, _stats("jax", -30.0, 30.0, 1),
                           _stats("jax", -10.0, 10.0, 5), jax_cp.cartpole_virtual_swingup(),
                           jax_cp.cartpole_virtual_cost(), horizon=H, n_steps=N_STEPS, w=W,
                           n_diffusion_steps_without_noise=N_TAIL, sample_override=chain)
    want = jax.jit(loop)(params, jnp.asarray(x0), key)

    port_chain = make_fused_cfg_chain(tm, make_schedule("exponential", T), n_samples=1, w=W,
                                      n_tail=N_TAIL, device="cpu")
    got = _port_loop(tm, sample_override=port_chain)(torch.from_numpy(x0), torch.from_numpy(noise))
    assert port_chain.plain_calls == N_STEPS and port_chain.launches == 0
    assert got.x_track.shape == (N_STEPS + 1, 5) and got.u_horizons.shape == (N_STEPS, H, 1)
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_closed_loop_ddpm_sampler_matches_chain_override(setup):
    """Without an override the replan samples through the port's
    GaussianDiffusion.ddpm_cfg_sample: same tracks as the chain."""
    _, _, tm, x0, _, noise = setup
    chain = make_fused_cfg_chain(tm, make_schedule("exponential", T), n_samples=1, w=W,
                                 n_tail=N_TAIL, device="cpu")
    a = _port_loop(tm, sample_override=chain)(torch.from_numpy(x0), torch.from_numpy(noise))
    b = _port_loop(tm)(torch.from_numpy(x0), torch.from_numpy(noise))
    for name in ("x_track", "u_track", "stage_costs"):
        np.testing.assert_allclose(getattr(a, name).numpy(), getattr(b, name).numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_closed_loop_draws_noise_from_generator(setup):
    _, _, tm, x0, _, _ = setup
    loop = _port_loop(tm, n_steps=2)
    runs = [loop(torch.from_numpy(x0), generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    torch.testing.assert_close(runs[0].x_track, runs[1].x_track, rtol=0, atol=0)
    assert not torch.equal(runs[0].u_track, runs[2].u_track)
    with pytest.raises(ValueError, match="noise must be"):
        loop(torch.from_numpy(x0), torch.zeros(2, 3, 1, H, 1))
