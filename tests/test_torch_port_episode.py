"""The port's whole-episode CFG closed loop (ops/fused_episode.py) against the
JAX package's ``make_fused_cfg_episode`` in interpret mode, against the
port's own per-replan loop, and the episode kernel's program emulated in
numpy on the packed buffer and the meta table.

The U-Net is small (horizon 8, ``unet_input_dim`` 8, ``dim_mults`` (1, 2),
numpy-seeded weights carried across by ``from_flax_params``), on the
cart-pole swing-up with ``bench.py``'s synthetic limits, T = 10 + 2 tail
steps, 3 replans: interpret mode is slow at full width. The noise is the
draw the JAX episode makes from each key of ``jax.random.split``, handed
over as numpy. Tolerance rtol = atol = 1e-4, the JAX suite's for episodes
(tests/test_fused_episode.py:59): per-replan fp32 differences of ~1e-6 in
u_norm, times 30 after unnormalizing, pass through the plant steps.
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
from mpc_via_diffusion_model_tpu_torch.control import make_closed_loop, make_replan_fn
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import NormalizerStats
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.dynamics import (Plant, cartpole_virtual_cost,
                                                        cartpole_virtual_swingup,
                                                        theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.models import TemporalUnet, from_flax_params, load_flagship
from mpc_via_diffusion_model_tpu_torch.ops import unet_pack as up
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import (affine_consts, episode_choice,
                                                                 make_fused_cfg_episode)
from torch_port_util import emulate_cfg_episode_kernel, randomize

FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts" / "flagship" / "ema_params.pkl"
T, N_TAIL, W, N_STEPS, H = 10, 2, 0.01, 3, 8
TOL = 1e-4
X0 = np.array([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], np.float32)


def _models(cfg_indicator: bool, seed: int = 31):
    cfg = dict(state_dim=1, n_support_points=H, unet_input_dim=8, dim_mults=(1, 2),
               context_dim=5, cfg_indicator=cfg_indicator)
    jm = JaxUnet(conditioning_type="default", **cfg)
    args = [jnp.zeros((1, H, 1)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 5))]
    if cfg_indicator:
        args.append(jnp.zeros((1, 1)))
    params = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args), seed)
    tm = TemporalUnet(**cfg)
    tm.load_state_dict(from_flax_params(params))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def models():
    return {bit: _models(bit) for bit in (True, False)}


def _stats(lib):
    if lib == "jax":
        return (JaxStats("limits", jnp.full((1,), -30.0), jnp.full((1,), 30.0)),
                JaxStats("limits", jnp.full((5,), -10.0), jnp.full((5,), 10.0)))
    return (NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0)),
            NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0)))


def _jax_noise(key, k: int) -> np.ndarray:
    """(n_steps, n_total + 1, K, H, 1): the draws the JAX episode and the JAX
    runtime make from each replan key, before the episode's reorder."""
    return np.stack([np.asarray(jax.random.normal(kk, (T + N_TAIL + 1, k, H, 1), jnp.float32))
                     for kk in jax.random.split(key, N_STEPS)])


def _port_episode(tm, k=1, sel_h=None, n_steps=N_STEPS, **kw):
    ins, cs = _stats("torch")
    return make_fused_cfg_episode(tm, make_schedule("exponential", T), ins, cs,
                                  cartpole_virtual_swingup(), cartpole_virtual_cost(),
                                  n_steps=n_steps, w=W, n_diffusion_steps_without_noise=N_TAIL,
                                  n_candidates=k, selection_horizon=sel_h, device="cpu", **kw)


@pytest.mark.parametrize("k,sel_h,cfg_bit", [(1, None, True), (3, None, True), (3, 4, True),
                                             (1, None, False)])
def test_plain_episode_matches_jax_episode_interpret(models, k, sel_h, cfg_bit):
    jm, params, tm = models[cfg_bit]
    ins, cs = _stats("jax")
    key = jax.random.PRNGKey(7 + k)
    want = jax_episode(jm, params, jax_make_schedule("exponential", T), ins, cs,
                       jax_cp.cartpole_virtual_swingup(), jax_cp.cartpole_virtual_cost(),
                       n_steps=N_STEPS, w=W, n_diffusion_steps_without_noise=N_TAIL,
                       n_candidates=k, selection_horizon=sel_h, interpret=True)(jnp.asarray(X0), key)
    ep = _port_episode(tm, k, sel_h)
    got = ep(torch.from_numpy(X0), torch.from_numpy(_jax_noise(key, k)))
    assert (ep.launches, ep.plain_calls) == (0, 1)
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        assert g.shape == np.asarray(w_).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("k,sel_h", [(1, None), (3, 4), (3, None)])
def test_plain_episode_matches_port_closed_loop(models, k, sel_h):
    """The episode against make_closed_loop(n_candidates=K) on the same
    noise: the affine normalizers and the unrolled stage cost round
    otherwise than the runtime's, within the tolerance."""
    tm = models[True][2]
    noise = torch.from_numpy(_jax_noise(jax.random.PRNGKey(3), k))
    x_tr, u_tr, costs = _port_episode(tm, k, sel_h)(torch.from_numpy(X0), noise)
    ins, cs = _stats("torch")
    ref = make_closed_loop(GaussianDiffusion(make_schedule("exponential", T)), tm, ins, cs,
                           cartpole_virtual_swingup(), cartpole_virtual_cost(), horizon=H,
                           n_steps=N_STEPS, w=W, n_diffusion_steps_without_noise=N_TAIL,
                           n_candidates=k, selection_horizon=sel_h, device="cpu")(
        torch.from_numpy(X0), noise)
    for name, g, w_ in (("x_track", x_tr, ref.x_track), ("u_track", u_tr, ref.u_track),
                        ("stage_costs", costs, ref.stage_costs)):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("scores", [[3.0, np.nan, 1.0, np.nan], [2.0, 1.0, 1.0, 4.0],
                                    [np.nan, 0.5], [5.0, 4.0, 3.0]])
def test_nan_selection_rules_match_their_references(scores):
    """The runtime picks by torch.argmin, which picks as jnp.argmin does (a
    NaN wins); the episode as the JAX episode kernel's min/where (a NaN
    chooses none: index K)."""
    s = np.asarray(scores, np.float32)
    k = len(s)
    assert int(torch.argmin(torch.from_numpy(s))) == int(jnp.argmin(jnp.asarray(s)))
    ck = jnp.asarray(s)[None]
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, k), 1)
    jax_kernel_rule = int(jnp.min(jnp.where(ck == jnp.min(ck), iota, k)))
    assert episode_choice(torch.from_numpy(s)) == jax_kernel_rule


def test_nan_score_paths_diverge_as_pinned(models):
    """A NaN plan for candidate 1 at the first replan: the runtime applies
    that candidate (jnp.argmin's rule), the episode chooses none (index K)
    and applies the one-hot product, 0 * NaN."""
    tm = models[True][2]
    noise = torch.from_numpy(_jax_noise(jax.random.PRNGKey(5), 3))
    noise[0, 1:, 1] = float("nan")
    ep = _port_episode(tm, 3, 4)
    _, u_tr, _, chosen = ep.plain(torch.from_numpy(X0), noise)
    assert int(chosen[0]) == 3 and torch.isnan(u_tr[0]).all()
    ins, cs = _stats("torch")
    replan = make_replan_fn(GaussianDiffusion(make_schedule("exponential", T)), tm, ins, cs, H,
                            w=W, n_diffusion_steps_without_noise=N_TAIL, n_candidates=3,
                            plant=cartpole_virtual_swingup(), cost=cartpole_virtual_cost(),
                            selection_horizon=4)
    u_hor, u_cand = replan(torch.from_numpy(X0), noise[0])
    assert torch.isnan(u_cand[1]).all() and not torch.isnan(u_cand[0]).any()
    assert torch.isnan(u_hor).all()  # candidate 1, the NaN, was applied


@pytest.mark.parametrize("which,k,sel_h", [("small", 1, None), ("small", 3, 5),
                                           ("small", 3, None), ("flagship", 2, 6)])
def test_episode_kernel_program_emulation_matches_plain(models, which, k, sel_h):
    """The episode kernel's program, FiLM from the packed FiLM weights at
    the meta table's offsets and the selection from the consts table, run in
    numpy on a NaN-filled shared image of the episode plan, equals the plain
    episode: the only CPU check of those offsets and of the plan."""
    if which == "small":
        tm, schedule, n_tail, n_steps = models[True][2], make_schedule("exponential", T), N_TAIL, N_STEPS
    else:  # full width, a short chain and one replan: numpy is slow at 128 channels
        tm, schedule, n_tail, n_steps = load_flagship(FLAGSHIP, device="cpu"), make_schedule("exponential", 3), 1, 1
    ins, cs = _stats("torch")
    ep = make_fused_cfg_episode(tm, schedule, ins, cs, cartpole_virtual_swingup(),
                                cartpole_virtual_cost(), n_steps=n_steps, w=W,
                                n_diffusion_steps_without_noise=n_tail, n_candidates=k,
                                selection_horizon=sel_h, device="cpu")
    noise = torch.from_numpy(np.random.RandomState(k).randn(*ep.noise_shape).astype(np.float32))
    want = ep.plain(torch.from_numpy(X0), noise)
    noise_tab = torch.cat([noise[:, 1:], noise[:, :1]], dim=1).numpy()
    got = emulate_cfg_episode_kernel(ep.packed, ep.weights, ep.t_embs.numpy(), noise_tab,
                                     ep.coefs.numpy(), ep.consts.numpy(), X0, W, k,
                                     ep.selection_horizon, n_steps)
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        assert np.all(np.isfinite(g)), name
        np.testing.assert_allclose(g, w_.numpy(), rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(got[3], want[3].numpy())
    m = ep.meta.numpy()
    assert m[up.M_COND] == tm.time_emb_dim + tm.context_dim + 1
    assert ep.smem_bytes <= up.SMEM_LIMIT


def test_affine_consts_match_jax():
    from mpc_via_diffusion_model_tpu.ops.fused_episode import _affine_consts
    rng = np.random.RandomState(0)
    mins = (rng.randn(5) * 3).astype(np.float32)
    maxs = mins + rng.rand(5).astype(np.float32) * 10 + 0.1
    got = affine_consts(NormalizerStats("limits", torch.from_numpy(mins), torch.from_numpy(maxs)), 5)
    want = _affine_consts(JaxStats("limits", jnp.asarray(mins), jnp.asarray(maxs)), 5)
    for g, w_ in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w_))


def test_episode_wrapper_dispatch_and_refusals(models):
    tm = models[True][2]
    ep = _port_episode(tm, 1, n_steps=1)
    noise = torch.zeros(ep.noise_shape)
    x_tr, u_tr, costs = ep(torch.from_numpy(X0), noise)
    assert x_tr.shape == (2, 5) and u_tr.shape == (1, 1) and costs.shape == (1,)
    assert (ep.launches, ep.plain_calls) == (0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        ep.kernel(torch.from_numpy(X0), noise)  # a CPU tensor never reaches the kernel
    with pytest.raises(ValueError, match="noise must be"):
        ep(torch.from_numpy(X0), noise[:, :-1])
    other = Plant("pendulum", 2, 1, 0.05, lambda x, u: x)
    ins, cs = _stats("torch")
    sched = make_schedule("exponential", T)
    for kw, match in ((dict(plant=other), "pendulum"),
                      (dict(selection_cost=object()), "QuadraticCost"),
                      (dict(state_to_condition=lambda x: x), "state_to_condition"),
                      (dict(inkernel_noise=True), "inkernel_noise")):
        args = dict(plant=cartpole_virtual_swingup(), cost=cartpole_virtual_cost())
        args.update(kw)
        with pytest.raises(NotImplementedError, match=match):
            make_fused_cfg_episode(tm, sched, ins, cs, device="cpu", **args)


@pytest.mark.gpu
@pytest.mark.parametrize("k,sel_h", [(1, None), (4, 8)])
def test_cfg_episode_kernel_matches_plain_on_gpu(k, sel_h):
    """The CUDA episode kernel against its plain version on the card, at the
    flagship's full width, 4 replans. Sums in other orders than cuDNN's;
    the tracks carry them through the plant: 1e-3, chip_smoke.py's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    ins, cs = _stats("torch")
    ep = make_fused_cfg_episode(load_flagship(FLAGSHIP, device="cuda"), make_schedule("exponential", 25),
                                ins, cs, cartpole_virtual_swingup(), cartpole_virtual_cost(),
                                n_steps=4, n_candidates=k, selection_horizon=sel_h, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    noise = torch.randn(ep.noise_shape, generator=gen, device="cuda")
    x0 = torch.from_numpy(X0).cuda()
    got = ep.kernel(x0, noise)
    torch.cuda.synchronize()
    want = ep.plain(x0, noise)
    assert ep.launches == 1
    for g, w_ in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w_, atol=1e-3, rtol=1e-3)
    assert torch.equal(got[3], want[3])
