"""The CFG episode on the linear cart-pole of the LMPC workload
(``cfg_episode_lmpc``: ``ops/csrc/cfg_episode_lmpc.cu`` with
``plants.cuh``'s ``CartpoleLmpc``) on the CPU: its plain version against
the JAX package's ``make_fused_cfg_episode`` with ``cartpole_lmpc`` in
interpret mode; the kernel's program emulated in numpy (8 NaN-filled
shared-memory images with the race check) against the plain version, at a
small width and at the LMPC weights' full width, beside the CFG chain's
program at horizon 8; the device function's order of operations; and the
plants and weights the wrapper refuses. The CUDA checks are marked ``gpu``.

The small U-Net has the LMPC model's structure (horizon 8, ``dim_mults``
(1, 2, 4), context 4, the context-present bit) at width 8, its
numpy-seeded weights drawn at scale 0.1 so that most sampled controls lie
inside the limits: a control clipped at a limit would hide a difference.
Limits are the LMPC dataset's (``data/lmpc_stats.py``); T = 10 + 2 tail
steps, 6 replans. Tolerance 1e-4, the JAX suite's for episodes.
"""
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
from mpc_via_diffusion_model_tpu.ops.fused_episode import make_fused_cfg_episode as jax_episode
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import lmpc_stats, normalize
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_lmpc, cartpole_lmpc_cost,
                                                        cartpole_virtual_cost,
                                                        cartpole_virtual_stabilized)
from mpc_via_diffusion_model_tpu_torch.models import TemporalUnet, from_flax_params, load_lmpc
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import make_fused_cfg_chain
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import (CFG_ENTRIES,
                                                                 make_fused_cfg_episode,
                                                                 make_fused_ddim_episode)
from mpc_via_diffusion_model_tpu_torch.scripts.lmpc_parity import sweep_states
from torch_port_util import (cartpole_lmpc_step_f32, emulate_cfg_chain_kernel,
                             emulate_cfg_episode_kernel, randomize)

torch.set_num_threads(1)

LMPC = Path(__file__).resolve().parents[1] / "artifacts" / "flagship_lmpc" / "ema_params.pkl"
T, N_TAIL, W, N_STEPS, H = 10, 2, 0.01, 6, 8
TOL = 1e-4
X0 = sweep_states(1)[0].numpy()


@pytest.fixture(scope="module")
def models():
    cfg = dict(state_dim=1, n_support_points=H, unet_input_dim=8, dim_mults=(1, 2, 4),
               context_dim=4, cfg_indicator=True)
    jm = JaxUnet(conditioning_type="default", **cfg)
    args = [jnp.zeros((1, H, 1)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 4)), jnp.zeros((1, 1))]
    params = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args), 41, scale=0.1)
    tm = TemporalUnet(**cfg)
    tm.load_state_dict(from_flax_params(params))
    return jm, params, tm.eval()


def _jax_stats():
    return tuple(JaxStats("limits", jnp.asarray(s.mins.numpy()), jnp.asarray(s.maxs.numpy()))
                 for s in lmpc_stats())


def _episode(tm, k=1, n_steps=N_STEPS, t=T, n_tail=N_TAIL, device="cpu", **kw):
    ins, cs = lmpc_stats()
    return make_fused_cfg_episode(tm, make_schedule("exponential", t), ins, cs, cartpole_lmpc(),
                                  cartpole_lmpc_cost(), n_steps=n_steps, w=W,
                                  n_diffusion_steps_without_noise=n_tail, n_candidates=k,
                                  device=device, **kw)


def _jax_noise(key, k: int) -> np.ndarray:
    """(n_steps, n_total + 1, K, H, 1): the JAX episode's draws from each replan key."""
    return np.stack([np.asarray(jax.random.normal(kk, (T + N_TAIL + 1, k, H, 1), jnp.float32))
                     for kk in jax.random.split(key, N_STEPS)])


def _inside_share(u_track: torch.Tensor) -> float:
    """The share of controls strictly inside the dataset's limits (not clipped)."""
    u_norm = normalize(lmpc_stats()[0], u_track)
    return float((u_norm.abs() < 1 - 1e-6).float().mean())


@pytest.mark.parametrize("k", [1, 3])
def test_plain_lmpc_episode_matches_jax_episode_interpret(models, k):
    jm, params, tm = models
    ins, cs = _jax_stats()
    key = jax.random.PRNGKey(17 + k)
    want = jax_episode(jm, params, jax_make_schedule("exponential", T), ins, cs,
                       jax_cp.cartpole_lmpc(), jax_cp.cartpole_lmpc_cost(), n_steps=N_STEPS, w=W,
                       n_diffusion_steps_without_noise=N_TAIL, n_candidates=k,
                       interpret=True)(jnp.asarray(X0), key)
    ep = _episode(tm, k)
    assert ep.name == "cfg_episode_lmpc" and ep.consts.numel() == 5 * 4 + 4 * 1 + 1 + 20
    got = ep(torch.from_numpy(X0), torch.from_numpy(_jax_noise(key, k)))
    assert (ep.launches, ep.plain_calls) == (0, 1)
    assert _inside_share(got[1]) >= 0.5, got[1]
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        assert g.shape == np.asarray(w_).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL, atol=TOL, err_msg=name)


def test_lmpc_device_step_order_equals_torch_step_bitwise():
    """plants.cuh's CartpoleLmpc::step, emulated in float32 numpy in its
    order of operations from the consts the wrapper builds, equals the
    port's torch step bit for bit."""
    plant = cartpole_lmpc()
    pc = np.float32((plant.dt,) + plant.device_consts)
    rng = np.random.RandomState(8)
    x = (rng.randn(64, 4) * 2).astype(np.float32)
    u = (rng.randn(64, 1) * 10).astype(np.float32)
    want = plant.step(torch.from_numpy(x), torch.from_numpy(u)).numpy()
    got = np.stack([cartpole_lmpc_step_f32(x[i], u[i], pc) for i in range(64)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,sel_h", [(1, None), (3, None), (3, 5)])
def test_lmpc_episode_program_is_race_free_and_matches_plain(models, k, sel_h):
    """cfg_episode_lmpc's program on 8 NaN-filled images at the small
    width: the same tracks and choices as the plain episode, 29 cluster
    barriers per pass at three levels."""
    tm = models[2]
    n_steps, t, n_tail = 2, 2, 1
    ep = _episode(tm, k, n_steps=n_steps, t=t, n_tail=n_tail, selection_horizon=sel_h)
    noise = torch.from_numpy(np.random.RandomState(k).randn(*ep.noise_shape).astype(np.float32))
    want = ep.plain(torch.from_numpy(X0), noise)
    noise_tab = torch.cat([noise[:, 1:], noise[:, :1]], dim=1).numpy()
    *got, barriers = emulate_cfg_episode_kernel(
        ep.packed, ep.weights, ep.t_embs.numpy(), noise_tab, ep.coefs.numpy(), ep.consts.numpy(),
        X0, W, k, ep.selection_horizon, n_steps, plant_step=cartpole_lmpc_step_f32)
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        np.testing.assert_allclose(g, w_.numpy(), rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(got[3], want[3].numpy())
    assert barriers == 29 * n_steps * (t + n_tail) * k


@pytest.fixture(scope="module")
def lmpc_model():
    return load_lmpc(LMPC, device="cpu")


@pytest.mark.parametrize("k,n_steps,t,n_tail", [(1, 1, 25, 5), (2, 2, 3, 1)])
def test_lmpc_episode_program_at_full_width(lmpc_model, k, n_steps, t, n_tail):
    """The same program on the committed LMPC weights at full width (32, 64
    and 128 channels: a rank holds 4, 8 or 16 channels of 8, 4 or 2 rows
    per row-set) with the dataset's limits: one replan of the full chain
    (T = 25 + 5) at K = 1, and two of T = 3 + 1 at K = 2 (the emulator's
    cost grows with the depth; the layout does not)."""
    ep = _episode(lmpc_model, k, n_steps=n_steps, t=t, n_tail=n_tail)
    noise = torch.from_numpy(np.random.RandomState(5 + k).randn(*ep.noise_shape).astype(np.float32))
    want = ep.plain(torch.from_numpy(X0), noise)
    noise_tab = torch.cat([noise[:, 1:], noise[:, :1]], dim=1).numpy()
    *got, barriers = emulate_cfg_episode_kernel(
        ep.packed, ep.weights, ep.t_embs.numpy(), noise_tab, ep.coefs.numpy(), ep.consts.numpy(),
        X0, W, k, ep.selection_horizon, n_steps, plant_step=cartpole_lmpc_step_f32)
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        np.testing.assert_allclose(g, w_.numpy(), rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(got[3], want[3].numpy())
    assert barriers == 29 * n_steps * (t + n_tail) * k


@pytest.mark.parametrize("b", [1, 2])
def test_chain_program_at_horizon_8_full_width(lmpc_model, b):
    """cfg_chain.cu's program on the committed LMPC weights at horizon 8 and
    context 4, B samples of one cluster each, T = 3 + 1 steps."""
    chain = make_fused_cfg_chain(lmpc_model, make_schedule("exponential", 3), n_samples=b, w=W,
                                 n_tail=1, device="cpu")
    rng = np.random.RandomState(b)
    ctx = torch.from_numpy(rng.randn(b, 4).astype(np.float32))
    noise = torch.from_numpy(rng.randn(chain.n_total + 1, b, H, 1).astype(np.float32))
    want = chain.plain(ctx, noise).numpy()
    with torch.no_grad():
        films = chain.films(ctx).numpy()
    noise_tab = torch.cat([noise[1:], noise[:1]]).numpy()
    got, barriers = emulate_cfg_chain_kernel(chain.packed, chain.cluster.weights, films, noise_tab,
                                             chain.coefs.numpy(), W)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert barriers == [2 + 29 * chain.n_total] * b


def test_episode_refuses_plants_and_weights_without_an_entry(models):
    tm = models[2]
    ins, cs = lmpc_stats()
    sched = make_schedule("exponential", T)
    assert set(CFG_ENTRIES.values()) == {"cfg_episode", "cfg_episode_bf16", "cfg_episode_lmpc",
                                         "cfg_episode_quadrotor", "cfg_episode_panda"}
    with pytest.raises(NotImplementedError, match="cartpole_virtual_stabilized"):
        make_fused_cfg_episode(tm, sched, ins, cs, cartpole_virtual_stabilized(),
                               cartpole_virtual_cost(), device="cpu")
    with pytest.raises(NotImplementedError, match="no bf16 entry for the plant 'cartpole_lmpc'"):
        _episode(tm, weights_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="cartpole_lmpc"):
        make_fused_ddim_episode(tm, sched, [9], ins, cs, cartpole_lmpc(), cartpole_lmpc_cost(),
                                device="cpu")


def _near_ties(scores: torch.Tensor, rel: float = 1e-5) -> bool:
    """Whether the best two of K candidate scores differ by at most ``rel`` relative."""
    best2 = torch.sort(scores.double()).values[:2]
    return bool(best2[1] - best2[0] <= rel * best2[0].abs())


@pytest.mark.gpu
@pytest.mark.parametrize("k,n_steps", [(1, 10), (8, 4)])
def test_lmpc_episode_kernel_matches_plain_on_gpu(lmpc_model, k, n_steps):
    """The cfg_episode_lmpc entry against its plain version on the card on
    the committed weights, chip_smoke.py phase 22's check: tracks within
    1e-3; at K = 8 the candidates hardly differ, so choices are compared
    only where the plain scores' best two are more than 1e-5 apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    ep = _episode(load_lmpc(LMPC, device="cuda"), k, n_steps=n_steps, t=25, n_tail=5,
                  device="cuda")
    noise = torch.randn(ep.noise_shape, generator=torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    x0 = torch.from_numpy(X0).cuda()
    got = ep.kernel(x0, noise)
    torch.cuda.synchronize()
    want = ep.plain(x0, noise)
    assert ep.launches == 1
    for g, w_ in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w_, atol=1e-3, rtol=1e-3)
    decided = [not _near_ties(sc) for sc in ep.plain_scores] if k > 1 else [True] * n_steps
    for i, sure in enumerate(decided):
        assert not sure or got[3][i] == want[3][i], (i, got[3].tolist(), want[3].tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8])
def test_chain_kernel_at_horizon_8_matches_plain_on_gpu(lmpc_model, b):
    """The CFG chain kernel on the committed LMPC weights at horizon 8,
    context 4, against its plain version: 1e-4, chip_smoke.py's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    chain = make_fused_cfg_chain(load_lmpc(LMPC, device="cuda"), make_schedule("exponential", 25),
                                 n_samples=b, w=W, n_tail=5, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(b)
    ctx = torch.randn((b, 4), generator=gen, device="cuda")
    noise = torch.randn((31, b, H, 1), generator=gen, device="cuda")
    got = chain.kernel(ctx, noise)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, chain.plain(ctx, noise), atol=1e-4, rtol=1e-4)
