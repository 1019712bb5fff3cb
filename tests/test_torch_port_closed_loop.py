"""The slice as a whole: the port's cart-pole CFG closed loop against the
JAX package's ``make_closed_loop`` with the Pallas chain kernel (interpret
mode) as its sampler, for 8 replans from x0 = [0, 0, 3.0, 0, theta*(3.0)];
best-of-K against the JAX loop with K = 3, with and without
``selection_horizon``; and ``bench.py``'s ``BENCH_FUSED=1`` shape of the
loop, the plain sampler with a ``FusedUnet`` as the denoiser.

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
from mpc_via_diffusion_model_tpu_torch.control import make_closed_loop, make_replan_fn
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import NormalizerStats
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_cost,
                                                        cartpole_virtual_swingup,
                                                        theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import make_fused_cfg_chain
from mpc_via_diffusion_model_tpu_torch.ops.fused_unet import make_fused_unet
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


N_BEST = 4  # replans of the best-of-K loops


def _jax_noise_k(key, k: int, n_steps: int) -> np.ndarray:
    """(n_steps, n_total + 1, K, H, 1): the draw JAX's ddpm_cfg_sample makes
    from each replan key."""
    return np.stack([np.asarray(jax.random.normal(kk, (T + N_TAIL + 1, k, H, 1), jnp.float32))
                     for kk in jax.random.split(key, n_steps)])


@pytest.mark.parametrize("selection_horizon", [None, 6])
def test_best_of_k_matches_jax_closed_loop(setup, selection_horizon):
    """K = 3 candidates through the plain sampler, scored by the rollout
    cost (terminal cost only over the whole horizon): the same plan is
    applied at every replan as in the JAX loop, so u_horizons agree."""
    jm, params, tm, x0, _, _ = setup
    key = jax.random.PRNGKey(17)
    schedule = jax_make_schedule("exponential", T)
    loop = jax_closed_loop(JaxDiffusion(schedule=schedule), jm.apply, _stats("jax", -30.0, 30.0, 1),
                           _stats("jax", -10.0, 10.0, 5), jax_cp.cartpole_virtual_swingup(),
                           jax_cp.cartpole_virtual_cost(), horizon=H, n_steps=N_BEST, w=W,
                           n_diffusion_steps_without_noise=N_TAIL, n_candidates=3,
                           selection_horizon=selection_horizon)
    want = jax.jit(loop)(params, jnp.asarray(x0), key)
    noise = torch.from_numpy(_jax_noise_k(key, 3, N_BEST))
    got = _port_loop(tm, n_steps=N_BEST, n_candidates=3,
                     selection_horizon=selection_horizon)(torch.from_numpy(x0), noise)
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)
    # the applied plan is one of the replan's candidates, and not always the first
    replan = make_replan_fn(GaussianDiffusion(make_schedule("exponential", T)), tm,
                            _stats("torch", -30.0, 30.0, 1), _stats("torch", -10.0, 10.0, 5), H,
                            w=W, n_diffusion_steps_without_noise=N_TAIL, n_candidates=3,
                            plant=cartpole_virtual_swingup(), cost=cartpole_virtual_cost(),
                            selection_horizon=selection_horizon)
    picks = []
    for i in range(N_BEST):
        _, u_cand = replan(got.x_track[i], noise[i])
        picks.append([bool(torch.equal(u_cand[j], got.u_horizons[i])) for j in range(3)].index(True))
    assert set(picks) != {0}, picks


def test_best_of_k_with_chain_override_matches_plain_sampler(setup):
    """A FusedCfgChain with n_samples = K as the sampler of the best-of-K
    loop gives the plain sampler's tracks."""
    _, _, tm, x0, _, _ = setup
    noise = torch.from_numpy(_jax_noise_k(jax.random.PRNGKey(2), 3, N_BEST))
    chain = make_fused_cfg_chain(tm, make_schedule("exponential", T), n_samples=3, w=W,
                                 n_tail=N_TAIL, device="cpu")
    kw = dict(n_steps=N_BEST, n_candidates=3, selection_horizon=6)
    a = _port_loop(tm, sample_override=chain, **kw)(torch.from_numpy(x0), noise)
    b = _port_loop(tm, **kw)(torch.from_numpy(x0), noise)
    assert chain.plain_calls == N_BEST
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        np.testing.assert_allclose(getattr(a, name).numpy(), getattr(b, name).numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_fused_unet_denoiser_drives_the_plain_sampler(setup):
    """bench.py's BENCH_FUSED=1 path: the plain sampler with a FusedUnet
    (batch 2, the CFG doubling) as its denoiser, one call per chain step;
    on the CPU it runs the plain forward, with the module's tracks."""
    _, _, tm, x0, _, noise = setup
    fused = make_fused_unet(tm, batch_size=2, device="cpu")
    a = _port_loop(tm, n_steps=2)(torch.from_numpy(x0), torch.from_numpy(noise[:2]))
    loop = make_closed_loop(GaussianDiffusion(make_schedule("exponential", T)), fused,
                            _stats("torch", -30.0, 30.0, 1), _stats("torch", -10.0, 10.0, 5),
                            cartpole_virtual_swingup(), cartpole_virtual_cost(), horizon=H,
                            n_steps=2, w=W, n_diffusion_steps_without_noise=N_TAIL, device="cpu")
    b = loop(torch.from_numpy(x0), torch.from_numpy(noise[:2]))
    assert (fused.launches, fused.plain_calls) == (0, 2 * (T + N_TAIL))
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        torch.testing.assert_close(getattr(b, name), getattr(a, name), rtol=0, atol=0)


def test_selection_horizon_is_validated(setup):
    tm = setup[2]
    with pytest.raises(ValueError, match="selection_horizon"):
        _port_loop(tm, n_candidates=3, selection_horizon=H + 1)
    with pytest.raises(ValueError, match="plant and cost"):
        make_replan_fn(GaussianDiffusion(make_schedule("exponential", T)), tm,
                       _stats("torch", -30.0, 30.0, 1), _stats("torch", -10.0, 10.0, 5), H,
                       n_candidates=3)
