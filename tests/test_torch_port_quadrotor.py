"""The quadrotor student's serving path in the port against the JAX package
on the CPU: the 12-state plant (``dynamics/quadrotor.py``), its costs, the
task's copy in ``scripts/quadrotor_task.py`` against the top-level
``scripts/quadrotor_task.py`` (which only this test puts on ``sys.path``),
the dataset's statistics (``data/quadrotor_stats.py``), the student's
forward, the per-replan loop with best-of-K by the safety-first cost, and
the plain quadrotor episode against the JAX episode kernel in interpret mode,
all on the student's own weights (a random model's saturated plans roll the
quadrotor chaotically, so that no two libraries score its candidates alike).
The numpy twins of
the kernel's plant step and scorer (``tests/torch_port_util.py``) are held
bit for bit to the torch versions. The yardstick
(``data/quadrotor_yardstick.py``) regenerates under ``slow``.

Tolerances: 1e-6 for the plant and the costs (the libraries' sin and cos
differ in the last bit); rtol = atol = 1e-4 for loops and episodes, the JAX
suite's (tests/test_fused_episode.py:59).
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
from mpc_via_diffusion_model_tpu.data.datasets import ControlSequenceDataset
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.diffusion.distillation import (
    make_student_ddim_sampler as jax_student_sampler)
from mpc_via_diffusion_model_tpu.dynamics import get_plant as jax_get_plant
from mpc_via_diffusion_model_tpu.dynamics.quadrotor import obstacle_cost as jax_obstacle_cost
from mpc_via_diffusion_model_tpu.dynamics.quadrotor import (
    obstacle_cost_single as jax_obstacle_cost_single)
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu.ops.fused_episode import make_fused_ddim_episode as jax_episode
from mpc_via_diffusion_model_tpu_torch.control import make_closed_loop
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import quadrotor_stats as qs
from mpc_via_diffusion_model_tpu_torch.data import quadrotor_yardstick as qys
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion, make_student_ddim_sampler
from mpc_via_diffusion_model_tpu_torch.dynamics import (get_plant, obstacle_cost,
                                                        obstacle_cost_single, quadrotor,
                                                        quadrotor_cost)
from mpc_via_diffusion_model_tpu_torch.models import (QUADROTOR_STUDENT_CONFIG,
                                                      load_quadrotor_student)
from mpc_via_diffusion_model_tpu_torch.ops import unet_pack as up
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import make_fused_ddim_episode
from mpc_via_diffusion_model_tpu_torch.scripts import quadrotor_task as task
from torch_port_util import (quadrotor_step_f32, safety_first_stage_f32,
                             safety_first_terminal_f32)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import quadrotor_task as jax_task  # noqa: E402  (the JAX package's task, top-level scripts/)

torch.set_num_threads(1)

DATASET = ROOT / "artifacts" / "flagship_quadrotor" / "dataset.npz"
T, TOL = 25, 1e-4


def _states(n: int = 256, seed: int = 0) -> np.ndarray:
    """Seeded states: positions around the spheres, pitch near +-pi/2 (cos
    theta near 0, on both sides of the 1e-3 clamp), rates and velocities."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, 12) * np.array([1, 1, 1, 2, 2, 2, .5, .5, .5, 3, 3, 3])).astype(np.float32)
    x[:64, :3] = (task.OBS_CENTERS[rng.randint(0, 3, 64)] + rng.randn(64, 3) * 0.4).astype(np.float32)
    x[64:128, 7] = (np.pi / 2 + rng.randn(64) * 2e-3 * rng.choice([-1, 1], 64)).astype(np.float32)
    x[128:144, 7] = np.float32(-np.pi / 2) + rng.randn(16).astype(np.float32) * 1e-3
    return x


def _controls(n: int = 256, seed: int = 1) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 4) * np.array([6, 1, 1, 1]) + np.array([9.81, 0, 0, 0])).astype(np.float32)


def test_plant_and_costs_match_jax():
    """The step, the quadratic cost and both obstacle costs against the JAX
    package's. Where cos theta is near 0, tan theta reaches 1/1e-3 and
    multiplies the libraries' last-bit differences of sin and cos (torch's
    and XLA's) a thousandfold, so float32 is held to 1e-6 away from there
    (|cos theta| > 0.1), and every state, the clamp's included, in float64
    (XLA's float64 against torch's; the port's gravity is a float32
    constant, 4e-7 from XLA's float64 one)."""
    plant, cost = get_plant("quadrotor")
    jplant, jcost = jax_get_plant("quadrotor")
    assert (plant.name, plant.state_dim, plant.control_dim, plant.dt) == (
        jplant.name, jplant.state_dim, jplant.control_dim, jplant.dt)
    x, u = _states(), _controls()
    cth = np.cos(x[:, 7])
    assert np.sum(cth < 1e-3) > 8 and np.sum((cth > 1e-3) & (cth < 0.1)) > 8
    far = np.abs(cth) > 0.1
    assert far.sum() > 150
    want = np.asarray(jax.vmap(jplant.step)(jnp.asarray(x[far]), jnp.asarray(u[far])))
    got = plant.step(torch.from_numpy(x[far]), torch.from_numpy(u[far])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with jax.enable_x64(True):
        want64 = np.asarray(jax.vmap(jplant.step)(jnp.asarray(x, jnp.float64),
                                                  jnp.asarray(u, jnp.float64)))
    got64 = plant.step(torch.from_numpy(x).double(), torch.from_numpy(u).double()).numpy()
    np.testing.assert_allclose(got64, want64, rtol=1e-7, atol=1e-7)
    for name in ("q_diag", "r", "p_diag"):
        np.testing.assert_array_equal(getattr(cost, name).numpy(), np.asarray(getattr(jcost, name)))
    np.testing.assert_array_equal(np.float32(plant.device_consts), np.float32([1.0, .01, .01, .02]))
    c, r = task.OBS_CENTERS, task.OBS_RADII
    tracks = x[:240].reshape(10, 24, 12)
    np.testing.assert_allclose(obstacle_cost(torch.from_numpy(tracks), torch.from_numpy(c),
                                             torch.from_numpy(r)).numpy(),
                               np.asarray(jax_obstacle_cost(jnp.asarray(tracks), c, r)), rtol=1e-6)
    single = jax.vmap(lambda v: jax_obstacle_cost_single(v, jnp.asarray(c), jnp.asarray(r), 2e5))
    np.testing.assert_allclose(obstacle_cost_single(torch.from_numpy(x), torch.from_numpy(c),
                                                    torch.from_numpy(r), 2e5).numpy(),
                               np.asarray(single(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_task_and_select_costs_match_the_jax_task():
    """The task cost and the safety-first selection cost (stage and
    terminal) against the top-level scripts/quadrotor_task.py's; the scene,
    the hover thrust and the selection cost's kernel constants."""
    _, cost = get_plant("quadrotor")
    _, jcost = jax_get_plant("quadrotor")
    np.testing.assert_array_equal(task.OBS_CENTERS, jax_task.OBS_CENTERS)
    np.testing.assert_array_equal(task.OBS_RADII, jax_task.OBS_RADII)
    assert task.HOVER_THRUST == jax_task.HOVER_THRUST
    x, u = _states(), _controls()
    for port, jax_ in ((task.make_task_cost(cost), jax_task.make_task_cost(jcost)),
                       (task.make_select_cost(cost), jax_task.make_select_cost(jcost)),
                       (task.make_select_cost(cost, 0.3, 1e3), jax_task.make_select_cost(jcost, 0.3, 1e3))):
        np.testing.assert_allclose(port.stage(torch.from_numpy(x), torch.from_numpy(u)).numpy(),
                                   np.asarray(jax.vmap(jax_.stage)(x, u)), rtol=1e-6)
        np.testing.assert_allclose(port.terminal(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax.vmap(jax_.terminal)(x)), rtol=1e-6)
    sel = task.make_select_cost(cost)
    assert sel.scorer == "safety_first"
    np.testing.assert_array_equal(
        np.float32(sel.device_consts),
        np.concatenate([[9.81, 0, 0, 0, 0.05, 2e5], task.OBS_CENTERS.reshape(-1),
                        task.OBS_RADII + np.float32(0.15)]).astype(np.float32))


def test_kernel_twins_are_bit_equal_to_torch():
    """``Quadrotor::step``'s numpy twin, given torch's sin and cos, and the
    safety-first scorer's twins give the torch plant's and cost's bits."""
    plant, cost = quadrotor(), quadrotor_cost()
    sel = task.make_select_cost(cost)
    x, u = _states(), _controls()
    pc = np.float32([plant.dt, *plant.device_consts])
    tsin = lambda v: torch.sin(torch.tensor(v)).numpy()
    tcos = lambda v: torch.cos(torch.tensor(v)).numpy()
    twin = np.stack([quadrotor_step_f32(x[i], u[i], pc, tsin, tcos) for i in range(len(x))])
    np.testing.assert_array_equal(twin, plant.step(torch.from_numpy(x), torch.from_numpy(u)).numpy())
    sc = np.float32(sel.device_consts)
    q, r, p = (t.numpy() for t in (cost.q_diag, cost.r, cost.p_diag))
    np.testing.assert_array_equal(
        np.array([safety_first_stage_f32(q, r, sc, x[i], u[i]) for i in range(len(x))]),
        sel.stage(torch.from_numpy(x), torch.from_numpy(u)).numpy())
    np.testing.assert_array_equal(
        np.array([safety_first_terminal_f32(p, sc, x[i]) for i in range(len(x))]),
        sel.terminal(torch.from_numpy(x)).numpy())


def test_eval_starts_and_metrics_match_the_jax_task():
    np.testing.assert_array_equal(task.eval_start_states(64), jax_task.eval_start_states(64))
    np.testing.assert_array_equal(task.eval_start_states(5, 97), jax_task.eval_start_states(5, 97))
    rng = np.random.RandomState(3)
    xt = (rng.randn(6, 20, 12) * 0.8 + np.array([1.2, 0, 1] + [0] * 9)).astype(np.float32)
    xt[2, 5, 0] = np.nan
    costs = rng.rand(6, 19).astype(np.float32)
    np.testing.assert_array_equal(task.min_clearance(xt), jax_task.min_clearance(xt))
    assert task.track_metrics(xt, costs) == jax_task.track_metrics(xt, costs)
    assert "diverged_fraction" in task.track_metrics(xt)


def test_quadrotor_stats_equal_the_datasets():
    """The 32 committed limits are the JAX package's normalizer statistics
    of ``artifacts/flagship_quadrotor/dataset.npz``, exactly."""
    stats = ControlSequenceDataset.load(str(DATASET)).normalizer.stats
    ins, cond = qs.quadrotor_stats()
    for port, key in ((ins, "inputs"), (cond, "condition")):
        want = stats[key]
        assert port.kind == want.kind == "limits"
        np.testing.assert_array_equal(port.mins.numpy(), np.asarray(want.mins, np.float32).reshape(-1))
        np.testing.assert_array_equal(port.maxs.numpy(), np.asarray(want.maxs, np.float32).reshape(-1))
    assert ins.mins.shape == (4,) and cond.mins.shape == (12,)


def test_load_quadrotor_student_matches_jax_forward_and_splits():
    tm = load_quadrotor_student(qys.STUDENT, device="cpu")
    assert tm.cfg_indicator and sum(p.numel() for p in tm.parameters()) == 1_008_772
    with open(qys.STUDENT, "rb") as f:
        params = pickle.load(f)
    jm = JaxUnet(conditioning_type="default", cfg_indicator=True, **QUADROTOR_STUDENT_CONFIG)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 48, 4).astype(np.float32)
    t = np.array([23, 7], np.int32)
    ctx = rng.randn(2, 12).astype(np.float32)
    mask = np.zeros((2, 1), np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, x, t, ctx, mask))
    got = tm(torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)), torch.from_numpy(ctx),
             torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    packed = up.pack_unet(tm, "cpu")
    split = up.cluster_split(packed)  # widths 32/64/128, 8 groups: the cluster kernels take it
    assert len(split.convs) > 0
    # the misc region holds the 12-state and its context (episode.cuh's X_* offsets)
    assert packed.episode_smem_bytes(16, 1) - packed.episode_smem_bytes(1, 1) == 4 * 15 * 48 * 4 + 4 * 12
    assert packed.episode_smem_bytes(16, 1) <= up.SMEM_LIMIT


def _jax_stats():
    return (JaxStats("limits", jnp.asarray(qs.INPUTS_MINS, jnp.float32),
                     jnp.asarray(qs.INPUTS_MAXS, jnp.float32)),
            JaxStats("limits", jnp.asarray(qs.CONDITION_MINS, jnp.float32),
                     jnp.asarray(qs.CONDITION_MAXS, jnp.float32)))


def _jax_noise(key, k: int, n_steps: int, horizon: int) -> np.ndarray:
    """(n_steps, K, H, 4): each replan's initial draw from its key of
    ``jax.random.split``, as the JAX loop and episode draw it."""
    return np.stack([np.array(jax.random.normal(kk, (k, horizon, 4), jnp.float32))
                     for kk in jax.random.split(key, n_steps)])


def test_per_replan_loop_with_the_select_cost_matches_jax(student):
    """The student at full width through the port's make_closed_loop with
    its plain DDIM sampler, K = 3 scored by the safety-first cost, 5
    replans, against the JAX package's loop on JAX's draws."""
    n_steps, k = 5, 3
    jm, params, tm = student
    jplant, jcost = jax_get_plant("quadrotor")
    jsched = jax_make_schedule("exponential", T)
    sampler = jax_student_sampler(jsched, jm.apply, [23])
    x0 = task.eval_start_states(4)[1]
    key = jax.random.PRNGKey(5)
    loop = jax_closed_loop(JaxDiffusion(schedule=jsched), jm.apply, *_jax_stats(), jplant,
                           jax_task.make_select_cost(jcost), horizon=48, n_steps=n_steps,
                           n_candidates=k,
                           sample_override=lambda ctx, kk: sampler(params, ctx, kk, (k, 48, 4)))
    want = jax.jit(loop)(params, jnp.asarray(x0), key)
    sched = make_schedule("exponential", T)
    plant, cost = quadrotor(), quadrotor_cost()
    got = make_closed_loop(GaussianDiffusion(sched), tm, *qs.quadrotor_stats(), plant,
                           task.make_select_cost(cost), horizon=48, n_steps=n_steps,
                           n_candidates=k, sample_override=make_student_ddim_sampler(sched, tm, [23]),
                           noise_shape=(k, 48, 4), device="cpu")(
        torch.from_numpy(x0), torch.from_numpy(_jax_noise(key, k, n_steps, 48)))
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.fixture(scope="module")
def student():
    with open(qys.STUDENT, "rb") as f:
        params = pickle.load(f)
    jm = JaxUnet(conditioning_type="default", cfg_indicator=True, **QUADROTOR_STUDENT_CONFIG)
    return jm, params, load_quadrotor_student(qys.STUDENT, device="cpu")


@pytest.mark.parametrize("times,k", [([23], 1), ([23, 15, 7], 3)])
def test_plain_quadrotor_episode_matches_jax_episode_interpret(student, times, k):
    """The port's plain quadrotor episode (the quadrotor entry's plain
    version) against the JAX episode kernel in interpret mode, the
    quadrotor plant, K = 1 and K = 3 scored by make_select_cost, 3 replans
    of the student at full width."""
    jm, params, tm = student
    n_steps = 3
    jplant, jcost = jax_get_plant("quadrotor")
    key = jax.random.PRNGKey(40 + k)
    x0 = task.eval_start_states(2)[0]
    want = jax_episode(jm, params, jax_make_schedule("exponential", T), times, *_jax_stats(),
                       jplant, jcost, n_steps=n_steps, n_candidates=k,
                       selection_cost=jax_task.make_select_cost(jcost) if k > 1 else None,
                       interpret=True)(jnp.asarray(x0), key)
    plant, cost = quadrotor(), quadrotor_cost()
    ep = make_fused_ddim_episode(tm, make_schedule("exponential", T), times, *qs.quadrotor_stats(),
                                 plant, cost, n_steps=n_steps, n_candidates=k,
                                 selection_cost=task.make_select_cost(cost) if k > 1 else None,
                                 device="cpu")
    assert ep.name == "ddim_episode_quadrotor" and ep.consts.numel() == 99
    got = ep(torch.from_numpy(x0), torch.from_numpy(_jax_noise(key, k, n_steps, 48)))
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL, atol=TOL, err_msg=name)


def test_episode_entries_and_refusals(student):
    """The quadrotor has its entry and its in-kernel draw; the swing-up and
    the CFG episode have no draw, the quadrotor's entry no quadratic scorer
    at K > 1, and a state_to_condition or an unknown selection cost no
    entry: each raises NotImplementedError, at K = 1 and K > 1 alike."""
    tm = student[2]
    sched, ins_cond = make_schedule("exponential", T), qs.quadrotor_stats()
    plant, cost = quadrotor(), quadrotor_cost()
    make = lambda **kw: make_fused_ddim_episode(tm, sched, [23], *ins_cond, plant, cost,
                                                n_steps=2, device="cpu", **kw)
    assert make(inkernel_noise=True).name == "ddim_episode_quadrotor_draw"
    assert make(inkernel_noise=True).noise_shape == (2,)
    assert make(n_candidates=1, selection_cost=cost).consts[-18:].abs().sum() == 0
    for kw, match in ((dict(n_candidates=2, selection_cost=cost), "safety_first cost, not a quadratic"),
                      (dict(selection_cost=object()), "SafetyFirstCost only"),
                      (dict(state_to_condition=lambda x: x), "state_to_condition")):
        with pytest.raises(NotImplementedError, match=match):
            make(**kw)
    ep = make(inkernel_noise=True)
    with pytest.raises(ValueError, match="seed must be"):
        ep(torch.from_numpy(task.eval_start_states(1)[0]), torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        ep.kernel(torch.from_numpy(task.eval_start_states(1)[0]), torch.zeros(2, dtype=torch.int32))


@pytest.mark.slow
def test_yardstick_regenerates():
    """The JAX package's 64-start protocol at K = 1 and K = 16 on the CPU
    gives every literal of (a) and (b) of data/quadrotor_yardstick.py (~35 s)."""
    with open(qys.STUDENT, "rb") as f:
        params = pickle.load(f)
    jm = JaxUnet(conditioning_type="default", cfg_indicator=True, **QUADROTOR_STUDENT_CONFIG)
    jplant, jcost = jax_get_plant("quadrotor")
    jsched = jax_make_schedule("exponential", qys.T)
    sampler = jax_student_sampler(jsched, jm.apply, qys.TIMES)
    starts = jnp.asarray(jax_task.eval_start_states(qys.N_STARTS, qys.START_SEED))
    keys = jax.random.split(jax.random.PRNGKey(qys.KEY_SEED), qys.N_STARTS)
    for k in (1, 16):
        cost = jcost if k == 1 else jax_task.make_select_cost(jcost)
        loop = jax_closed_loop(JaxDiffusion(schedule=jsched), jm.apply, *_jax_stats(), jplant, cost,
                               horizon=48, n_steps=qys.N_STEPS, n_candidates=k,
                               sample_override=lambda ctx, kk, k=k: sampler(params, ctx, kk,
                                                                            (k, 48, 4)))
        xt = np.asarray(jax.jit(jax.vmap(lambda x0, kk: loop(params, x0, kk).x_track))(starts, keys))
        assert jax_task.track_metrics(xt) == qys.METRICS[k]
        assert tuple(float(v) for v in jax_task.min_clearance(xt)) == getattr(qys, f"CLEARANCE_K{k}")
        assert tuple(float(v) for v in np.linalg.norm(xt[:, -1, :3], axis=-1)) == getattr(
            qys, f"GOAL_DIST_K{k}")


def test_divergence_loop_is_the_runtime_loop_batched(student):
    """``scripts/quadrotor_divergence.py``'s loop over a batch of starts
    against ``make_closed_loop`` start by start (K = 3, 2 replans; the
    batched convs sum in other orders), and the yardstick's bounds cover
    every metric at K = 1 and K = 16."""
    from mpc_via_diffusion_model_tpu_torch.scripts import quadrotor_divergence as div
    tm = student[2]
    starts = task.eval_start_states(2)
    noise = torch.randn((2, 2, 3, 48, 4), generator=torch.Generator().manual_seed(0))
    got = div.batched_closed_loop(tm, torch.from_numpy(starts), noise, 3)
    sched = make_schedule("exponential", qys.T)
    loop = make_closed_loop(GaussianDiffusion(sched), tm, *qs.quadrotor_stats(), quadrotor(),
                            task.make_select_cost(quadrotor_cost()), horizon=48, n_steps=2,
                            n_candidates=3, sample_override=make_student_ddim_sampler(sched, tm, [23]),
                            noise_shape=(3, 48, 4), device="cpu")
    for i in range(2):
        np.testing.assert_allclose(got[i].numpy(), loop(torch.from_numpy(starts[i]), noise[i]).x_track
                                   .numpy(), rtol=TOL, atol=TOL)
    for k in (1, 16):
        assert set(qys.BOUNDS[k]) == set(div.METRICS) and qys.within(qys.METRICS[k], k)
        assert all(qys.BOUNDS[k][m] >= 2 / 64 for m in div.METRICS if m.endswith("fraction"))


def test_bench_script_refuses_the_fleet_and_reports_outside_artifacts():
    from mpc_via_diffusion_model_tpu_torch.scripts import bench_quadrotor_student as bench
    with pytest.raises(SystemExit, match="ROADMAP.md B5"):
        bench.main(["--fleet", "64", "--device", "cpu"])
    with pytest.raises(SystemExit, match="not artifacts/"):
        bench.main(["--out", str(ROOT / "artifacts" / "onpolicy_quadrotor" / "bench.json"),
                    "--device", "cpu"])


@pytest.mark.slow
def test_bench_script_runs_on_cpu(tmp_path):
    """Every row of the port's bench at toy depth (~1 min): 2 starts, 2
    replans, K = 2 through the loop and the episode, the in-kernel draw at
    K = 1 and 2."""
    from mpc_via_diffusion_model_tpu_torch.scripts import bench_quadrotor_student as bench
    out = bench.main(["--device", "cpu", "--eval-starts", "2", "--steps", "2", "--rate-steps", "3",
                      "--candidates", "2", "--in-kernel", "--inkernel-noise", "1", "2",
                      "--out", str(tmp_path / "bench.json")])
    for key in ("xla", "episode", "xla_k2", "episode_k2", "inkernel_noise_k1", "inkernel_noise_k2",
                "xla_hz_pipelined", "episode_hz_sustained", "episode_k2_hz_sustained",
                "inkernel_noise_k2_hz_sustained_single_dispatch"):
        assert key in out, key
    assert out["episode_vs_xla_max_err"] < 1e-3 and "within_yardstick" in out["episode"]
