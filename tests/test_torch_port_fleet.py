"""The fleet of episodes (``_Episode.fleet``, ops/fused_episode.py): N
independent episodes of kernel 5 (the DDIM episode) and kernel 3 (the CFG
episode), the port of the JAX package's ``jax.vmap`` of an episode, which
lifts its Pallas kernel to a grid axis (scripts/bench_throughput.py:190-208,
scripts/bench_quadrotor_student.py:185-206). On the CPU the fleet runs the
plain version episode by episode; here it is held against ``jax.vmap`` of
the JAX episode builders in interpret mode over distinct starts and the keys
of ``jax.random.split``, each episode on the draws JAX makes from its key,
handed over as numpy. Then the fleet's refusals and counts, the grid of N
clusters that one fleet launch runs (``torch_port_util.emulate_episode_grid``
over the kernels' offset formula, ``episode_offsets``, each cluster the
emulated DDIM episode program), and the quadrotor's bf16 DDIM entry (ROADMAP
B1) against JAX's quadrotor episode with bf16 weights.

The models are test_torch_port_ddim.py's and test_torch_port_episode.py's:
horizon 8, widths 8/16 (``dim_mults`` (1, 2)), numpy-seeded weights carried
across by ``from_flax_params``. Tolerance rtol = atol = 1e-4, the JAX suite's
for episodes (tests/test_fused_episode.py:59); the bf16 entry under
test_torch_port_b1.py's bf16 rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu.dynamics import get_plant as jax_get_plant
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu.ops.fused_episode import make_fused_cfg_episode as jax_cfg_episode
from mpc_via_diffusion_model_tpu.ops.fused_episode import make_fused_ddim_episode as jax_ddim_episode
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import NormalizerStats
from mpc_via_diffusion_model_tpu_torch.data import quadrotor_stats as qs
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_collect_cost,
                                                        cartpole_virtual_cost,
                                                        cartpole_virtual_swingup, quadrotor,
                                                        quadrotor_cost, theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.models import TemporalUnet, from_flax_params
from mpc_via_diffusion_model_tpu_torch.models.bf16 import bf16_conv_copy
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import (episode_offsets,
                                                                 make_fused_cfg_episode,
                                                                 make_fused_ddim_episode)
from mpc_via_diffusion_model_tpu_torch.scripts import quadrotor_task as task
from torch_port_util import emulate_ddim_episode_kernel, emulate_episode_grid, randomize

torch.set_num_threads(1)

H, T, TOL = 8, 25, 1e-4
T_CFG, N_TAIL, W = 10, 2, 0.01
N_FLEET, N_STEPS = 3, 3
X0 = np.array([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], np.float32)
# the bf16 rule of test_torch_port_b1.py: the median and largest gap to JAX, and the known-wrong
# function (the final 1x1 conv left fp32) at least WRONG_FACTOR times farther in the median
TOL_MEDIAN, TOL_BF16, WRONG_FACTOR = 1e-5, 1e-2, 10.0


def _models(seed, state_dim=1, context_dim=5, dim_mults=(1, 2)):
    cfg = dict(state_dim=state_dim, n_support_points=H, unet_input_dim=8, dim_mults=dim_mults,
               context_dim=context_dim, cfg_indicator=True)
    jm = JaxUnet(conditioning_type="default", **cfg)
    args = [jnp.zeros((1, H, state_dim)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, context_dim)), jnp.zeros((1, 1))]
    params = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args), seed)
    tm = TemporalUnet(**cfg)
    tm.load_state_dict(from_flax_params(params))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def ddim_models():
    return _models(71)  # test_torch_port_ddim.py's


@pytest.fixture(scope="module")
def cfg_models():
    return _models(31)  # test_torch_port_episode.py's


def _stats(lib):
    if lib == "jax":
        return (JaxStats("limits", jnp.full((1,), -30.0), jnp.full((1,), 30.0)),
                JaxStats("limits", jnp.full((5,), -10.0), jnp.full((5,), 10.0)))
    return (NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0)),
            NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0)))


def _starts(n):
    """n distinct starts: the flagship's x0 with the cart moved."""
    x0s = np.tile(X0, (n, 1))
    x0s[:, 0] = np.linspace(-0.4, 0.4, n, dtype=np.float32)
    return x0s


def _ddim_noise(key, k, n_steps=N_STEPS, shape=(H, 1)):
    """(n_steps, K, H, D): each replan's initial draw as the JAX episode stages it from its key
    (fused_episode.py:384-387)."""
    return np.stack([np.array(jax.random.normal(kk, (k, *shape), jnp.float32))
                     for kk in jax.random.split(key, n_steps)])


def _cfg_noise(key, k, n_steps):
    """(n_steps, n_total + 1, K, H, 1): the CFG episode's draws from each replan key."""
    return np.stack([np.asarray(jax.random.normal(kk, (T_CFG + N_TAIL + 1, k, H, 1), jnp.float32))
                     for kk in jax.random.split(key, n_steps)])


def _ddim_episode(tm, times, k=1, sel_h=None, n_steps=N_STEPS):
    ins, cs = _stats("torch")
    return make_fused_ddim_episode(tm, make_schedule("exponential", T), times, ins, cs,
                                   cartpole_virtual_swingup(), cartpole_virtual_collect_cost(),
                                   n_steps=n_steps, n_candidates=k, selection_horizon=sel_h,
                                   device="cpu")


def _assert_fleet(got, want):
    for name, g, w_ in zip(("x_tracks", "u_tracks", "stage_costs"), got, want):
        assert g.shape == np.asarray(w_).shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("times,k,sel_h", [([23, 15, 7], 1, None), ([23, 15, 7], 3, 5)])
def test_ddim_fleet_matches_jax_vmap(ddim_models, times, k, sel_h):
    """(a) The DDIM episode's fleet of 3 (distinct starts, one key each) against ``jax.vmap``
    of the JAX builder in interpret mode."""
    jm, params, tm = ddim_models
    ins, cs = _stats("jax")
    keys = jax.random.split(jax.random.PRNGKey(5 + k), N_FLEET)
    episode = jax_ddim_episode(jm, params, jax_make_schedule("exponential", T), times, ins, cs,
                               jax_cp.cartpole_virtual_swingup(),
                               jax_cp.cartpole_virtual_collect_cost(), n_steps=N_STEPS,
                               n_candidates=k, selection_horizon=sel_h, interpret=True)
    want = jax.vmap(episode)(jnp.asarray(_starts(N_FLEET)), keys)
    ep = _ddim_episode(tm, times, k, sel_h)
    noise = np.stack([_ddim_noise(kk, k) for kk in keys])
    got = ep.fleet(torch.from_numpy(_starts(N_FLEET)), torch.from_numpy(noise))
    assert (ep.launches, ep.plain_calls) == (0, N_FLEET)
    assert tuple(ep.last_chosen.shape) == (N_FLEET, N_STEPS)
    _assert_fleet(got, want)


def test_cfg_fleet_matches_jax_vmap(cfg_models):
    """(b) The CFG episode's fleet of 2 episodes of 2 replans against ``jax.vmap`` of the JAX
    builder in interpret mode."""
    jm, params, tm = cfg_models
    n, n_steps = 2, 2
    ins, cs = _stats("jax")
    keys = jax.random.split(jax.random.PRNGKey(9), n)
    episode = jax_cfg_episode(jm, params, jax_make_schedule("exponential", T_CFG), ins, cs,
                              jax_cp.cartpole_virtual_swingup(), jax_cp.cartpole_virtual_cost(),
                              n_steps=n_steps, w=W, n_diffusion_steps_without_noise=N_TAIL,
                              interpret=True)
    want = jax.vmap(episode)(jnp.asarray(_starts(n)), keys)
    ins, cs = _stats("torch")
    ep = make_fused_cfg_episode(tm, make_schedule("exponential", T_CFG), ins, cs,
                                cartpole_virtual_swingup(), cartpole_virtual_cost(),
                                n_steps=n_steps, w=W, n_diffusion_steps_without_noise=N_TAIL,
                                device="cpu")
    noise = np.stack([_cfg_noise(kk, 1, n_steps) for kk in keys])
    got = ep.fleet(torch.from_numpy(_starts(n)), torch.from_numpy(noise))
    assert (ep.launches, ep.plain_calls) == (0, n)
    _assert_fleet(got, want)


def test_fleet_refusals_counts_and_the_fleet_of_one(ddim_models):
    """(c) A fleet needs one N >= 1 in x0s and noise on one device, each episode of the
    episode's shapes; on the CPU it runs ``plain`` once per episode and launches nothing; the
    kernel path refuses CPU tensors before it reads a library (no fallback); ``episode`` is
    the fleet of one, bit for bit."""
    tm = ddim_models[2]
    ep = _ddim_episode(tm, [23], n_steps=2)
    x0s = torch.from_numpy(_starts(2))
    noise = torch.randn((2, *ep.noise_shape), generator=torch.Generator().manual_seed(0))
    bad = {"N = 0": (x0s[:0], noise[:0]), "N differs": (x0s, noise[:1]),
           "one x0": (x0s[0], noise), "an episode's noise": (x0s, noise[:, :1]),
           "mixed devices": (x0s, torch.empty(noise.shape, device="meta")),
           "float64": (x0s.double(), noise)}
    for what, (a, b) in bad.items():
        with pytest.raises(ValueError):
            ep.fleet(a, b)
        assert (ep.launches, ep.plain_calls) == (0, 0), what
    with pytest.raises(ValueError, match="CUDA"):
        ep.fleet_kernel(x0s, noise)
    with pytest.raises(ValueError, match="CUDA"):
        ep.kernel(x0s[0], noise[0])
    assert ep.launches == 0
    fleet = ep.fleet(x0s, noise)
    chosen = ep.last_chosen
    assert (ep.launches, ep.plain_calls) == (0, 2) and tuple(chosen.shape) == (2, 2)
    for e in range(2):
        one = ep.fleet(x0s[e:e + 1], noise[e:e + 1])
        single = ep(x0s[e], noise[e])
        for f, o, s in zip(fleet, one, single):
            assert torch.equal(o[0], s) and torch.equal(f[e], s)
        assert torch.equal(ep.last_chosen, chosen[e])
    assert (ep.launches, ep.plain_calls) == (0, 6)


def test_grid_of_clusters_writes_each_episode_once_through_the_offsets(ddim_models):
    """(d) One fleet launch as the kernels run it: a grid of 3 clusters of 8 CTAs, each CTA
    finding its episode as blockIdx.x / CLUSTER and its inputs and outputs in the flat buffers
    through ``episode_offsets``, each cluster the emulated DDIM episode program on its own
    NaN-filled images; every output element is written once, by its own episode, and the
    outputs are the plain fleet's. An offset formula one row off must fail."""
    tm = ddim_models[2]
    n, n_steps = 3, 2
    ep = _ddim_episode(tm, [23, 15, 7], n_steps=n_steps)
    x0s = _starts(n)
    noise = np.random.RandomState(4).standard_normal((n, *ep.noise_shape)).astype(np.float32)
    args = (ep.packed, ep.weights, ep.t_embs.numpy(), None, ep.coefs.numpy(), ep.consts.numpy())

    def cluster(x0, nz):
        out = emulate_ddim_episode_kernel(*args[:3], nz, *args[4:], x0, 1, ep.selection_horizon,
                                          n_steps)
        return out[:4]

    got = emulate_episode_grid(x0s, noise, n_steps, 1, episode_offsets, cluster)
    want = ep.fleet(torch.from_numpy(x0s), torch.from_numpy(noise))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[3], ep.last_chosen.numpy())

    def one_row_off(e, n_steps_, dx, du, noise_len):  # x_track as if it held n_steps rows
        return dict(episode_offsets(e, n_steps_, dx, du, noise_len), x_track=e * n_steps_ * dx)

    with pytest.raises(AssertionError, match="x_track"):
        emulate_episode_grid(x0s, noise, n_steps, 1, one_row_off, cluster)


def test_quadrotor_bf16_entry_matches_jax(ddim_models):
    """ROADMAP B1's last entry: the plain version of ``ddim_episode_quadrotor_bf16``
    (``bf16_conv_copy(model)``, the final 1x1 conv rounded) against JAX's quadrotor episode with
    ``weights_dtype=jnp.bfloat16`` in interpret mode, on JAX's draws, under
    test_torch_port_b1.py's rule; the controls in normalized units, the known-wrong function the
    final 1x1 conv left fp32. A one-level quadrotor-shaped model (4 controls, context 12) at
    test_torch_port_b1.py's grid near t = 0, where a random model's reconstructions mostly stay
    inside [-1, 1]."""
    jm, params, tm = _models(41, state_dim=4, context_dim=12, dim_mults=(1,))
    times, t_bf16, n_steps = [2, 0], 10, 2
    jplant, jcost = jax_get_plant("quadrotor")
    jstats = (JaxStats("limits", jnp.asarray(qs.INPUTS_MINS, jnp.float32),
                       jnp.asarray(qs.INPUTS_MAXS, jnp.float32)),
              JaxStats("limits", jnp.asarray(qs.CONDITION_MINS, jnp.float32),
                       jnp.asarray(qs.CONDITION_MAXS, jnp.float32)))
    key = jax.random.PRNGKey(6)
    x0 = task.eval_start_states(2)[0]
    want = jax_ddim_episode(jm, params, jax_make_schedule("exponential", t_bf16), times, *jstats,
                            jplant, jcost, n_steps=n_steps, weights_dtype=jnp.bfloat16,
                            interpret=True)(jnp.asarray(x0), key)
    ep_of = lambda model, wd: make_fused_ddim_episode(
        model, make_schedule("exponential", t_bf16), times, *qs.quadrotor_stats(), quadrotor(),
        quadrotor_cost(), n_steps=n_steps, weights_dtype=wd, device="cpu")
    ep = ep_of(tm, torch.bfloat16)
    assert ep.name == "ddim_episode_quadrotor_bf16"
    noise = torch.from_numpy(_ddim_noise(key, 1, n_steps, (H, 4)))
    got = ep(torch.from_numpy(x0), noise)
    wrong = ep_of(bf16_conv_copy(tm, round_final_1x1=False), torch.float32)(torch.from_numpy(x0),
                                                                           noise)
    u_unit = (0.5 * (qs.quadrotor_stats()[0].maxs - qs.quadrotor_stats()[0].mins)).numpy()
    g, w_, wr = (np.asarray(a, np.float64) / u_unit for a in (got[1], want[1], wrong[1]))
    right_med, wrong_med = float(np.median(np.abs(g - w_))), float(np.median(np.abs(wr - w_)))
    assert right_med <= TOL_MEDIAN and float(np.abs(g - w_).max()) <= TOL_BF16, right_med
    assert wrong_med > WRONG_FACTOR * max(right_med, 1e-7), (right_med, wrong_med)
