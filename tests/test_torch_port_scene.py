"""The scene-conditioned quadrotor student's serving path in the port
against the JAX package on the CPU: the scenes and their features
(``scripts/quadrotor_task.py``) against the top-level task module (which
only this test puts on ``sys.path``), the 24-dim condition statistics
(``data/scene_stats.py``) against the JAX script's ``c24_stats``, the
student's forward, the plain scene episode (the ``cfg_episode_quadrotor``
entry's plain version: the state followed by the scene's features as the
context, the scene's safety-first scorer) against the JAX CFG episode kernel
with the same ``state_to_condition`` in interpret mode, the new kernel
program emulated in numpy with the cluster race check, the refusals, and the
bench script's. The yardstick (``data/scene_yardstick.py``) regenerates
under ``slow``.

Tolerances: rtol = atol = 1e-4 for loops and episodes, the JAX suite's
(tests/test_fused_episode.py:157-160).
"""
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.control import make_closed_loop as jax_closed_loop
from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.data.normalization import fit_normalizer as jax_fit_normalizer
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.dynamics import get_plant as jax_get_plant
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu.ops.fused_episode import make_fused_cfg_episode as jax_episode
from mpc_via_diffusion_model_tpu_torch.control import ConcatFeatures, make_closed_loop
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import quadrotor_stats as qs
from mpc_via_diffusion_model_tpu_torch.data import scene_yardstick as sys_
from mpc_via_diffusion_model_tpu_torch.data.scene_stats import scene_stats
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.dynamics import quadrotor, quadrotor_cost
from mpc_via_diffusion_model_tpu_torch.models import (SCENE_STUDENT_CONFIG,
                                                      load_quadrotor_student, load_scene_student)
from mpc_via_diffusion_model_tpu_torch.ops import unet_pack as up
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import (CFG_ENTRIES, condition_kind,
                                                                 make_fused_cfg_episode,
                                                                 make_fused_ddim_episode)
from mpc_via_diffusion_model_tpu_torch.scripts import quadrotor_task as task
from mpc_via_diffusion_model_tpu_torch.scripts import scene_divergence as div
from torch_port_util import (concat_features_condition, emulate_cfg_episode_kernel,
                             quadrotor_select, quadrotor_step_f32)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import quadrotor_task as jax_task  # noqa: E402  (the JAX package's task, top-level scripts/)

torch.set_num_threads(1)

TOL = 1e-4
QUADROTOR = ROOT / "artifacts" / "onpolicy_quadrotor" / "student_1eval.pkl"


def test_sample_scenes_and_features_equal_the_jax_tasks():
    """``sample_scenes`` (numpy) bit for bit, and ``scene_features`` of one
    scene and of a batch, against the JAX task's."""
    for n, seed in ((1, 99), (7, 123), (50, 5)):
        got, want = task.sample_scenes(n, seed=seed), jax_task.sample_scenes(n, seed=seed)
        for g, w_ in zip(got, want):
            assert g.dtype == w_.dtype == np.float32
            np.testing.assert_array_equal(g, w_)
        c, r = got
        np.testing.assert_array_equal(task.scene_features(c, r).numpy(),
                                      np.asarray(jax_task.scene_features(c, r)))
        np.testing.assert_array_equal(task.scene_features(c[0], r[0]).numpy(),
                                      np.asarray(jax_task.scene_features(c[0], r[0])))


def _jax_c24():
    """The JAX script's statistics (bench_scene_student.py:80-90): the
    teacher's, and the 24-dim condition limits."""
    sc_c, sc_r = jax_task.sample_scenes(50_000, seed=123)
    feat = jax_fit_normalizer(np.asarray(jax_task.scene_features(sc_c, sc_r)))
    ins = JaxStats("limits", jnp.asarray(qs.INPUTS_MINS, jnp.float32),
                   jnp.asarray(qs.INPUTS_MAXS, jnp.float32))
    c24 = JaxStats("limits", mins=jnp.concatenate([jnp.asarray(qs.CONDITION_MINS, jnp.float32),
                                                   feat.mins]),
                   maxs=jnp.concatenate([jnp.asarray(qs.CONDITION_MAXS, jnp.float32), feat.maxs]))
    return ins, c24


@pytest.fixture(scope="module")
def jax_stats():
    return _jax_c24()


def test_scene_stats_equal_the_jax_scripts(jax_stats):
    """The 24 condition limits equal the JAX script's ``c24_stats`` exactly
    (its teacher's 12 are ``data/quadrotor_stats.py``'s, tested against the
    dataset in ``test_torch_port_quadrotor.py``), and the inputs' are the
    teacher's."""
    ins, cond = scene_stats()
    j_ins, j_c24 = jax_stats
    assert ins.kind == cond.kind == "limits" and cond.mins.shape == (24,)
    for port, want in ((ins, j_ins), (cond, j_c24)):
        np.testing.assert_array_equal(port.mins.numpy(), np.asarray(want.mins, np.float32))
        np.testing.assert_array_equal(port.maxs.numpy(), np.asarray(want.maxs, np.float32))


@pytest.fixture(scope="module")
def student():
    with open(sys_.STUDENT, "rb") as f:
        params = pickle.load(f)
    jm = JaxUnet(conditioning_type="default", cfg_indicator=True, **SCENE_STUDENT_CONFIG)
    return jm, params, load_scene_student(sys_.STUDENT, device="cpu")


def test_load_scene_student_matches_jax_forward_and_splits(student):
    """The context-24 pickle against Flax ``apply``; the cluster kernels take
    its widths, and its episode's shared memory at K = 1, 4 and 16."""
    jm, params, tm = student
    assert tm.cfg_indicator and sum(p.numel() for p in tm.parameters()) == 1_019_524
    rng = np.random.RandomState(3)
    x = rng.randn(2, 48, 4).astype(np.float32)
    t = np.array([24, 3], np.int32)
    ctx = rng.randn(2, 24).astype(np.float32)
    mask = np.array([[0.0], [1.0]], np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, x, t, ctx, mask))
    got = tm(torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)), torch.from_numpy(ctx),
             torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    packed = up.pack_unet(tm, "cpu")
    assert len(up.cluster_split(packed).convs) > 0
    # the misc region holds the 12-state and the 24-wide context (episode.cuh's X_* offsets)
    assert [packed.episode_smem_bytes(k, 2) for k in (1, 4, 16)] == [146_288, 148_592, 157_856]


def _scene(index: int = 0):
    return div.scene(index)


def _episode(tm, k, n_steps, t=sys_.T, n_tail=sys_.N_TAIL, index=0, **kw):
    cen, rad = _scene(index)
    plant, cost = quadrotor(), quadrotor_cost()
    return make_fused_cfg_episode(
        tm, make_schedule("exponential", t), *scene_stats(), plant, cost, n_steps=n_steps,
        w=sys_.W, n_diffusion_steps_without_noise=n_tail, n_candidates=k,
        selection_cost=task.make_select_cost(cost, centers=cen, radii=rad) if k > 1 else None,
        state_to_condition=ConcatFeatures(task.scene_features(cen, rad)), device="cpu", **kw)


@pytest.mark.parametrize("k", [1, 3])
def test_plain_scene_episode_matches_jax_episode_interpret(student, jax_stats, k):
    """The port's plain scene episode against the JAX CFG episode kernel in
    interpret mode with the scene's ``state_to_condition`` and, at K = 3,
    its ``make_select_cost``: the student at full width, 2 replans of T = 4
    + 1,
    scene 0 of the held-out draw."""
    jm, params, tm = student
    n_steps, t, n_tail = 2, 4, 1
    cen, rad = (jnp.asarray(a) for a in _scene())
    feat = jax_task.scene_features(cen, rad)
    jplant, jcost = jax_get_plant("quadrotor")
    key = jax.random.PRNGKey(50 + k)
    x0 = sys_.eval_starts()[k]
    want = jax_episode(jm, params, jax_make_schedule("exponential", t), *jax_stats, jplant, jcost,
                       n_steps=n_steps, w=sys_.W, n_diffusion_steps_without_noise=n_tail,
                       n_candidates=k,
                       selection_cost=(jax_task.make_select_cost(jcost, centers=cen, radii=rad)
                                       if k > 1 else None),
                       state_to_condition=lambda x: jnp.concatenate([x, feat]),
                       interpret=True)(jnp.asarray(x0), key)
    ep = _episode(tm, k, n_steps, t, n_tail)
    assert ep.name == "cfg_episode_quadrotor" and ep.consts.numel() == 135
    noise = np.stack([np.array(jax.random.normal(kk, (t + n_tail + 1, k, 48, 4), jnp.float32))
                      for kk in jax.random.split(key, n_steps)])
    got = ep(torch.from_numpy(x0), torch.from_numpy(noise))
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("k,index", [(1, 0), (3, 1)])
def test_scene_episode_program_is_race_free_and_matches_plain(student, k, index):
    """cfg_episode_quadrotor.cu's program at the student's full width on 8
    NaN-filled images (``_Cluster`` checks every push between two cluster
    barriers for races): the quadrotor's step, the context the state
    followed by the 12 features read from the consts table after the
    plant's, and at K = 3 the safety-first scorer, whose constants follow
    the features', against the plain episode's tracks and choices; two
    scenes of one layout. One replan of T = 2 + 1 (the emulator's cost grows
    with the depth; the layout does not)."""
    tm = student[2]
    n_steps, t, n_tail = 1, 2, 1
    ep = _episode(tm, k, n_steps, t, n_tail, index=index)
    x0 = sys_.eval_starts()[5]
    noise = torch.from_numpy(np.random.RandomState(k).randn(*ep.noise_shape).astype(np.float32))
    want = ep.plain(torch.from_numpy(x0), noise)
    noise_tab = torch.cat([noise[:, 1:], noise[:, :1]], dim=1).numpy()
    *got, barriers = emulate_cfg_episode_kernel(
        ep.packed, ep.weights, ep.t_embs.numpy(), noise_tab, ep.coefs.numpy(), ep.consts.numpy(),
        x0, sys_.W, k, ep.selection_horizon, n_steps, plant_step=quadrotor_step_f32,
        select=quadrotor_select(4, 12), condition=concat_features_condition(12))
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        np.testing.assert_allclose(g, w_.numpy(), rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(got[3], want[3].numpy())
    assert barriers == 29 * n_steps * (t + n_tail) * k
    features = ep.consts.numpy()[2 * 24 + 4 + 4 + 12 + 4 + 12 + 4 + 12 + 5:][:12]
    np.testing.assert_array_equal(features, task.scene_features(*_scene(index)).numpy())


def test_scene_episode_refusals(student):
    """The quadrotor's CFG entry runs the state followed by 12 features and
    nothing else: any other map raises NotImplementedError (a lambda, the
    identity), as does a ConcatFeatures in the DDIM episode; a model whose
    context is not 24 wide or a map with other than 12 features raise
    ValueError."""
    tm = student[2]
    assert CFG_ENTRIES["quadrotor", False] == "cfg_episode_quadrotor"
    assert condition_kind(None) == "identity" and condition_kind(lambda x: x) is None
    feat = task.scene_features(*_scene())
    sched, plant, cost = make_schedule("exponential", 2), quadrotor(), quadrotor_cost()
    make = lambda model, **kw: make_fused_cfg_episode(model, sched, *scene_stats(), plant, cost,
                                                      n_steps=1, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="state_to_condition"):
        make(tm, state_to_condition=lambda x: torch.cat([x, feat]))
    with pytest.raises(NotImplementedError, match="by concat_features, not identity"):
        make(tm)
    with pytest.raises(ValueError, match="reads 12 constants"):
        make(tm, state_to_condition=ConcatFeatures(feat[:6]))
    with pytest.raises(ValueError, match="context_dim must be 24, got 12"):
        make(load_quadrotor_student(QUADROTOR, device="cpu"), state_to_condition=ConcatFeatures(feat))
    with pytest.raises(NotImplementedError, match="by identity, not concat_features"):
        make_fused_ddim_episode(tm, sched, [1], *scene_stats(), plant, cost, n_steps=1,
                                state_to_condition=ConcatFeatures(feat), device="cpu")
    with pytest.raises(NotImplementedError, match="safety_first cost, not a quadratic"):
        make(tm, n_candidates=2, selection_cost=cost, state_to_condition=ConcatFeatures(feat))


def test_divergence_loop_is_the_runtime_loop_batched(student):
    """``scripts/scene_divergence.py``'s loop over a batch of starts against
    ``make_closed_loop`` with the scene's ``ConcatFeatures`` start by start
    (K = 2, 1 replan; the batched convs sum in other orders), and the
    yardstick's bounds cover every metric at K = 1 and K = 16."""
    tm = student[2]
    starts = sys_.eval_starts()[:2]
    cen, rad = _scene()
    noise = torch.randn((2, 1, 31, 2, 48, 4), generator=torch.Generator().manual_seed(0))
    got = div.batched_closed_loop(tm, torch.from_numpy(starts), noise, 2, cen, rad)
    loop = make_closed_loop(GaussianDiffusion(make_schedule("exponential", sys_.T)), tm,
                            *scene_stats(), quadrotor(),
                            task.make_select_cost(quadrotor_cost(), centers=cen, radii=rad),
                            horizon=48, n_steps=1, n_candidates=2,
                            state_to_condition=ConcatFeatures(task.scene_features(cen, rad)),
                            device="cpu")
    for i in range(2):
        np.testing.assert_allclose(got[i].numpy(), loop(torch.from_numpy(starts[i]), noise[i])
                                   .x_track.numpy(), rtol=TOL, atol=TOL)
    for k in (1, 16):
        assert set(sys_.BOUNDS[k]) == set(div.METRICS) and sys_.within(sys_.METRICS[k], k)
        assert all(sys_.BOUNDS[k][m] >= 2 / 16 for m in div.METRICS if m.endswith("fraction"))


def test_bench_script_reports_outside_artifacts():
    from mpc_via_diffusion_model_tpu_torch.scripts import bench_scene_student as bench
    with pytest.raises(SystemExit, match="not artifacts/"):
        bench.main(["--out", str(ROOT / "artifacts" / "scene_conditioned" / "bench.json"),
                    "--device", "cpu"])


@pytest.mark.slow
def test_scene_yardstick_regenerates(student, jax_stats):
    """The JAX package's protocol at K = 1 and K = 16 on the CPU gives every
    literal of (a) and (b) of data/scene_yardstick.py (~4 min)."""
    jm, params, _ = student
    jplant, jcost = jax_get_plant("quadrotor")
    cen, rad = (jnp.asarray(a) for a in _scene(sys_.SCENE_INDEX))
    feat = jax_task.scene_features(cen, rad)
    starts = jnp.asarray(jax_task.eval_start_states(sys_.N_STARTS, seed=sys_.START_SEED))
    keys = jax.random.split(jax.random.PRNGKey(sys_.KEY_SEED), sys_.N_STARTS)
    for k in (1, 16):
        cost = jcost if k == 1 else jax_task.make_select_cost(jcost, centers=cen, radii=rad)
        loop = jax_closed_loop(JaxDiffusion(schedule=jax_make_schedule("exponential", sys_.T)),
                               jm.apply, *jax_stats, jplant, cost, horizon=48,
                               n_steps=sys_.N_STEPS, w=sys_.W,
                               n_diffusion_steps_without_noise=sys_.N_TAIL, n_candidates=k,
                               state_to_condition=lambda x: jnp.concatenate([x, feat]))
        xt = np.asarray(jax.jit(jax.vmap(lambda x0, kk: loop(params, x0, kk).x_track))(starts, keys))
        c, r = np.asarray(cen), np.asarray(rad)
        assert jax_task.track_metrics(xt, centers=c, radii=r) == sys_.METRICS[k]
        assert tuple(float(v) for v in jax_task.min_clearance(xt, c, r)) == getattr(
            sys_, f"CLEARANCE_K{k}")
        assert tuple(float(v) for v in np.linalg.norm(xt[:, -1, :3], axis=-1)) == getattr(
            sys_, f"GOAL_DIST_K{k}")
