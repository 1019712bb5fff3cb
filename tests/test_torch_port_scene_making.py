"""The scene study's making half in the port against the JAX package on the
CPU: ``make_lqr_hover_plan``, one guided sampling chunk of per-row scenes on
the quadrotor teacher at full width (JAX's noise injected), the first
fine-tune steps of the widened teacher on staged draws against JAX's
``make_scanned_train_steps``, the student's pickle read by the JAX package's
``TemporalUnet``, ``onpolicy_scene``'s labeler (per-row scenes, the LQR
candidate, the script's own NaN rule) against its JAX ``per_row``, its
on-policy chunk schedule, the paired gate of ``data/guided_yardstick.py``
and the two scripts at toy size. The yardsticks
(``data/scene_making_yardstick.py``, ``data/onpolicy_scene_yardstick.py``)
regenerate under ``slow``; the two kernels at this slice's batch sizes run
under ``gpu``.

Tolerances are stated per test: 1e-5 for the LQR plan (float32 through 48
plant steps), rtol = atol = 1e-4 for the sampled chunk (the JAX suite's for
chains), the float64 train step's 1e-9 of ``test_torch_port_train.py``.
"""
import copy
import functools
import json
import pickle
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu import train as jt
from mpc_via_diffusion_model_tpu.control import make_closed_loop as jax_closed_loop
from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.data.datasets import ControlSequenceDataset as JaxDataset
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.data.normalization import fit_normalizer as jax_fit
from mpc_via_diffusion_model_tpu.data.normalization import normalize as jax_normalize
from mpc_via_diffusion_model_tpu.data.normalization import unnormalize as jax_unnormalize
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.dynamics import get_plant as jax_get_plant
from mpc_via_diffusion_model_tpu.dynamics.base import rollout as jax_rollout
from mpc_via_diffusion_model_tpu.dynamics.base import rollout_with_cost as jax_rollout_with_cost
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu_torch.data import guided_yardstick as gys
from mpc_via_diffusion_model_tpu_torch.data import onpolicy_scene_yardstick as oys
from mpc_via_diffusion_model_tpu_torch.data import quadrotor_stats as qs
from mpc_via_diffusion_model_tpu_torch.data import scene_making_yardstick as mys
from mpc_via_diffusion_model_tpu_torch.data.normalization import NormalizerStats
from mpc_via_diffusion_model_tpu_torch.data.scene_stats import scene_stats
from mpc_via_diffusion_model_tpu_torch.dynamics import quadrotor, quadrotor_cost
from mpc_via_diffusion_model_tpu_torch.models import (QUADROTOR_TEACHER_CONFIG,
                                                      load_quadrotor_teacher, load_scene_student)
from mpc_via_diffusion_model_tpu_torch.scripts import onpolicy_scene as ops
from mpc_via_diffusion_model_tpu_torch.scripts import quadrotor_task as task
from mpc_via_diffusion_model_tpu_torch.scripts import scene_conditioned_quadrotor as scq

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import quadrotor_task as jax_task  # noqa: E402  (the JAX package's task, top-level scripts/)
import scene_conditioned_quadrotor as jax_scene  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-4
H = 48


def _np(x):
    return np.array(x, np.float32)


def _jax_stats():
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    return (JaxStats("limits", f32(qs.INPUTS_MINS), f32(qs.INPUTS_MAXS)),
            JaxStats("limits", f32(qs.CONDITION_MINS), f32(qs.CONDITION_MAXS)))


def _stats64():
    """The quadrotor's statistics in float64 (``plan_stats`` on float64 plans)."""
    ins, cond = qs.quadrotor_stats()
    return (NormalizerStats("limits", ins.mins.double(), ins.maxs.double()),
            NormalizerStats("limits", cond.mins.double(), cond.maxs.double()))


def _jax_c24():
    """The JAX script's 24-dim condition statistics (``:157-164``)."""
    sc_c, sc_r = jax_task.sample_scenes(50_000, seed=123)
    feat = jax_fit(np.asarray(jax_task.scene_features(sc_c, sc_r)))
    cond = _jax_stats()[1]
    return feat, JaxStats("limits", jnp.concatenate([cond.mins, feat.mins]),
                          jnp.concatenate([cond.maxs, feat.maxs]))


def _jax_model(ctx: int):
    return JaxUnet(conditioning_type="default", cfg_indicator=True,
                   **dict(QUADROTOR_TEACHER_CONFIG, context_dim=ctx))


# --------------------------------------------------------------------------- #
# The JAX package's making half and on-policy toy on the CPU (the yardsticks'
# source): the JAX script's steps 1-3 at --quick, with the fine-tune's
# per-step losses, and its step-4 student rows.
# --------------------------------------------------------------------------- #

def _jax_chunk_per_step(step_fn, n_inner):
    """``make_scanned_train_steps`` with every step's loss (its mean is the chunk's)."""
    def chunk(state, inputs_all, cond_all, key, batch_size):
        n = inputs_all.shape[0]

        def body(st, k):
            k_idx, k_loss = jax.random.split(k)
            idx = jax.random.randint(k_idx, (batch_size,), 0, n)
            st, metrics = step_fn(st, inputs_all[idx], cond_all[idx], k_loss)
            return st, metrics["loss"]

        return jax.lax.scan(body, state, jax.random.split(key, n_inner))

    return chunk


@functools.lru_cache(maxsize=None)
def _jax_making_parts():
    """The JAX script's objects of its making half: plant, dataset, teacher, models, diffusion,
    feature and 24-dim statistics."""
    plant, quad_cost = jax_get_plant("quadrotor")
    ds = JaxDataset.load(str(gys.TEACHER.parent / "dataset.npz"))
    with open(gys.TEACHER, "rb") as f:
        teacher12 = pickle.load(f)
    feat_stats, c24_stats = _jax_c24()
    return dict(plant=plant, quad_cost=quad_cost, ds=ds, teacher12=teacher12,
                model12=_jax_model(12), model24=_jax_model(24),
                diffusion=JaxDiffusion(schedule=jax_make_schedule("exponential", 25)),
                feat_stats=feat_stats, c24_stats=c24_stats)


@functools.lru_cache(maxsize=None)
def _jax_sample_chunk(b: int):
    """The JAX script's ``sample_chunk`` at B = b rows (``:175-195``), jitted,
    with the dataset's statistics (``data/quadrotor_stats.py``'s, exact)."""
    plant, _ = jax_get_plant("quadrotor")
    diffusion = JaxDiffusion(schedule=jax_make_schedule("exponential", 25))
    in_stats, c_stats = _jax_stats()
    per_grad = jax_task.make_penalty_grad(plant, in_stats, gys.GUIDE_SCALE, scene_args=True)
    with open(gys.TEACHER, "rb") as f:
        teacher12 = pickle.load(f)
    model12 = _jax_model(12)

    def sample_chunk(x0s, cen, rad, key):
        ctx12 = jax.vmap(lambda x: jax_normalize(c_stats, x))(x0s)
        u_norm = diffusion.ddpm_cfg_sample(
            lambda x, t, c, m: model12.apply(teacher12, x, t, c, m), (b, H, 4), key,
            ctx12, w=gys.W, n_diffusion_steps_without_noise=5,
            guide=lambda u: jax.vmap(per_grad)(u, x0s, cen, rad), n_guide_steps=1,
            t_start_guide=gys.T_START_SCENE)

        def plan_stats(u_n, x0, c, r):
            states = jax_rollout(plant, x0, jax_unnormalize(in_stats, u_n), unroll=H)
            return (jax_task.min_clearance_jax(states, c, r), jnp.linalg.norm(x0[0:3]),
                    jnp.linalg.norm(states[-1, 0:3]))

        return (u_norm, *jax.vmap(plan_stats)(u_norm, x0s, cen, rad))

    return jax.jit(sample_chunk)


def jax_making_quick(out_dir: Path) -> dict:
    """The JAX script's ``--quick`` making half and its student rows, as
    ``data/scene_making_yardstick.py`` records them; writes the student and
    the dataset into ``out_dir`` as the script does."""
    q = scq.QUICK
    j = _jax_making_parts()
    plant, quad_cost, ds, teacher12 = j["plant"], j["quad_cost"], j["ds"], j["teacher12"]
    model24, diffusion = j["model24"], j["diffusion"]
    in_stats = ds.normalizer.stats["inputs"]
    feat_stats, c24_stats = j["feat_stats"], j["c24_stats"]
    x0_pool, cn_pool = ds.condition, ds.condition_normalized
    b = q["chunk_rows"]
    sample_jit = _jax_sample_chunk(b)
    rng = np.random.RandomState(scq.POOL_SEED)
    train_c, train_r = jax_task.sample_scenes(q["n_sample_chunks"] * b, seed=scq.SCENE_DRAW_SEED)
    u_keep, c_keep, clear_keep = [], [], []
    key = jax.random.PRNGKey(scq.NOISE_SEED)
    for c in range(q["n_sample_chunks"]):
        idx = rng.randint(0, x0_pool.shape[0], b)
        cen, rad = train_c[c * b:(c + 1) * b], train_r[c * b:(c + 1) * b]
        key, k = jax.random.split(key)
        u_norm, clear, d0, d1 = (np.asarray(v) for v in sample_jit(
            x0_pool[jnp.asarray(idx)], jnp.asarray(cen), jnp.asarray(rad), k))
        keep = (clear > 0.05) & ((d1 <= 0.85 * d0) | (d0 < 0.5))
        feat_n = jax_normalize(feat_stats, jax_task.scene_features(cen, rad))
        ctx24 = np.concatenate([np.asarray(cn_pool[jnp.asarray(idx)]), np.asarray(feat_n)], 1)
        u_keep.append(u_norm[keep])
        c_keep.append(ctx24[keep])
        clear_keep.append(clear[keep])
    data_u, data_c = jnp.asarray(np.concatenate(u_keep)), jnp.asarray(np.concatenate(c_keep))
    n_drawn = q["n_sample_chunks"] * b
    init24 = model24.init(jax.random.PRNGKey(0), jnp.zeros((1, H, 4)), jnp.zeros((1,), jnp.int32),
                          jnp.zeros((1, 24)), jnp.zeros((1, 1)))
    params24 = jax_scene.widen_film_params(teacher12, init24, 12, 24, cfg_indicator=True)
    opt = jt.make_optimizer(lr=1e-3)
    chunk_fn = _jax_chunk_per_step(jt.make_train_step(diffusion, model24.apply, opt), q["chunk"])
    chunk_jit = jax.jit(lambda st, a, c, k: chunk_fn(st, a, c, k, q["batch_size"]))
    state = jt.TrainState(params=params24, ema_params=jax.tree_util.tree_map(jnp.copy, params24),
                          opt_state=opt.init(params24), step=jnp.int32(0))
    key, losses = jax.random.PRNGKey(scq.TRAIN_SEED), []
    for _ in range(q["finetune_steps"] // q["chunk"]):
        key, k = jax.random.split(key)
        state, ls = chunk_jit(state, data_u, data_c, k)
        losses.append(np.asarray(ls))
    student = jax.device_get(state.ema_params)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "scene_student_ema.pkl", "wb") as f:
        pickle.dump(student, f)
    np.savez_compressed(out_dir / "scene_dataset.npz", inputs_normalized=np.asarray(data_u),
                        condition_normalized=np.asarray(data_c))
    E, S, T = q["eval_scenes"], q["eval_starts"], q["eval_steps"]
    ev_c, ev_r = jax_task.sample_scenes(E, seed=99)
    starts = jnp.asarray(jax_task.eval_start_states(S, seed=11))
    pc, pr = jnp.repeat(jnp.asarray(ev_c), S, axis=0), jnp.repeat(jnp.asarray(ev_r), S, axis=0)
    px, pk = jnp.tile(starts, (E, 1)), jax.random.split(jax.random.PRNGKey(31), E * S)

    def run_scene(k_cand, cen, rad, x0, k):
        feat = jax_task.scene_features(cen, rad)
        cost = (jax_task.make_select_cost(quad_cost, centers=cen, radii=rad) if k_cand > 1
                else quad_cost)
        loop = jax_closed_loop(diffusion, model24.apply, in_stats, c24_stats, plant, cost,
                               horizon=H, n_steps=T, w=gys.W, n_diffusion_steps_without_noise=5,
                               n_candidates=k_cand,
                               state_to_condition=lambda x: jnp.concatenate([x, feat]))
        return loop(student, x0, k)

    rows = {}
    for k_cand in (1, q["select_k"]):
        runs = jax.jit(jax.vmap(functools.partial(run_scene, k_cand)))(pc, pr, px, pk)
        name = "scene_conditioned_student" + ("" if k_cand == 1 else f"_k{k_cand}")
        rows[name] = jax_task.track_metrics(np.asarray(runs.x_track), centers=np.asarray(pc),
                                            radii=np.asarray(pr))
    cc = jnp.tile(jnp.asarray(jax_task.OBS_CENTERS)[None], (S, 1, 1))
    cr = jnp.tile(jnp.asarray(jax_task.OBS_RADII)[None], (S, 1))
    runs = jax.jit(jax.vmap(functools.partial(run_scene, 1)))(
        cc, cr, starts, jax.random.split(jax.random.PRNGKey(47), S))
    rows["canonical_scene_student"] = jax_task.track_metrics(np.asarray(runs.x_track))
    losses = np.concatenate(losses)
    clear = np.concatenate(clear_keep)
    return {"n_drawn": n_drawn, "n_kept": int(data_u.shape[0]),
            "keep_fraction": int(data_u.shape[0]) / n_drawn,
            "kept_clearance_mean": float(clear.mean()),
            "first_losses": [float(v) for v in losses[:20]],
            "final_loss": float(losses[-q["chunk"]:].mean()), "rows": rows}


def jax_onpolicy_toy(scene_dir: Path, out_dir: Path) -> dict:
    """The JAX script ``scripts/onpolicy_scene.py`` at the toy size of
    ``data/onpolicy_scene_yardstick.py`` (``TOY_ARGS``) on the CPU, its
    collected pairs and rows."""
    cmd = [sys.executable, str(ROOT / "scripts" / "onpolicy_scene.py"), "--cpu",
           "--scene-dir", str(scene_dir), "--out", str(out_dir), *oys.TOY_ARGS]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True, cwd=ROOT).stdout
    pairs = [int(line.split("collect: ")[1].split()[0]) for line in log.splitlines()
             if "collect: " in line]
    report = json.loads((out_dir / "report.json").read_text())
    return {"pairs": pairs, "rows": {f"{r['student']}_k{r['K']}": {
        m: r[m] for m in oys.METRICS_KEYS} for r in report["rows"]}}


# --------------------------------------------------------------------------- #
# The tests
# --------------------------------------------------------------------------- #

def test_lqr_hover_plan_matches_jax():
    """``make_lqr_hover_plan`` against the JAX task's from 4 seeded states
    near hover and one far away: 1e-5 (float32 through 48 plant steps; the
    controls normalized and clipped)."""
    jplant, jqcost = jax_get_plant("quadrotor")
    ins = qs.quadrotor_stats()[0]
    jplan = jax.jit(lambda x: jax.vmap(
        jax_task.make_lqr_hover_plan(jplant, jqcost, _jax_stats()[0], H))(x))
    rng = np.random.RandomState(0)
    x = np.zeros((5, 12), np.float32)
    x[:, :3] = rng.uniform(-0.5, 0.5, (5, 3))
    x[:, 3:6] = rng.uniform(-0.2, 0.2, (5, 3))
    x[:, 6:9] = rng.uniform(-0.1, 0.1, (5, 3))
    x[4, :3] = [2.6, 0.5, 1.0]  # far from the linearization: saturates
    got = task.make_lqr_hover_plan(quadrotor(), quadrotor_cost(), ins, H)(torch.from_numpy(x))
    want = np.asarray(jplan(jnp.asarray(x)))
    assert got.shape == (5, H, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.abs(want[4]).max() == 1.0 and np.abs(want[:4]).max() < 1.0


@pytest.fixture(scope="module")
def teacher():
    return load_quadrotor_teacher(gys.TEACHER, device="cpu")


def test_guided_sampling_chunk_matches_jax(teacher):
    """One chunk of 8 rows of the making half on the teacher at full width:
    the pool's rows of ``RandomState(5)``, the scenes of ``sample_scenes(8,
    seed=1)``, JAX's draws of ``PRNGKey(17)``'s first split staged into the
    port's ``sample_chunk`` (the U-Net pass wrapper's plain version at 16
    rows), against the JAX script's ``sample_chunk`` and curation: the plans
    within rtol = atol = 1e-4, the clearances, d0 and d1 of JAX's plans
    within 1e-4 at the rows whose rollout is well conditioned (its float32
    numbers within 1e-5 of its float64 ones: a 48-step rollout amplifies a
    plan's last bits where the quadrotor tumbles), the port's keep mask equal
    to JAX's, the 24-dim context within 1e-6; a NaN clearance is rejected."""
    b = 8
    pool = scq.load_pool(gys.TEACHER.parent / "dataset.npz", "cpu")
    idx = np.random.RandomState(scq.POOL_SEED).randint(0, len(pool), b)
    cen, rad = task.sample_scenes(b, seed=scq.SCENE_DRAW_SEED)
    k = jax.random.split(jax.random.PRNGKey(scq.NOISE_SEED))[1]
    x0_np = pool.condition.numpy()[idx]
    u_j, clear_j, d0_j, d1_j = (np.asarray(v) for v in _jax_sample_chunk(b)(
        jnp.asarray(x0_np), jnp.asarray(cen), jnp.asarray(rad), k))
    noise = torch.from_numpy(_np(jax.random.normal(k, (gys.T + gys.N_TAIL + 1, b, H, 4))))
    fu = scq.make_fused_unet(teacher, 2 * b, device="cpu")
    ti = torch.from_numpy(idx)
    got = scq.sample_chunk(fu, pool.condition[ti], pool.condition_normalized[ti],
                           torch.from_numpy(cen), torch.from_numpy(rad), noise)
    assert fu.plain_calls == gys.T + gys.N_TAIL
    np.testing.assert_allclose(got["u_norm"].numpy(), u_j, rtol=TOL, atol=TOL)
    # a plan's 48-step rollout amplifies its last bits where the quadrotor tumbles (torch's and
    # XLA's float32 sin and cos differ by an ulp now and then), so the curation's numbers are
    # held on JAX's own plans, at the rows whose float32 rollout keeps to its float64 one
    u_t = torch.from_numpy(np.array(u_j))
    args = (pool.condition[ti], torch.from_numpy(cen), torch.from_numpy(rad))
    stats = scq.plan_stats(u_t, *args)
    with mock.patch.object(scq, "quadrotor_stats", _stats64):
        stats64 = scq.plan_stats(u_t.double(), *(a.double() for a in args))
    calm = np.ones(b, bool)
    for name in ("clear", "d1"):
        calm &= (stats[name].double() - stats64[name]).abs().numpy() < 1e-5
    assert calm.sum() >= 6
    for name, want in (("clear", clear_j), ("d0", d0_j), ("d1", d1_j)):
        np.testing.assert_allclose(stats[name].numpy()[calm], want[calm], rtol=TOL, atol=TOL,
                                   err_msg=name)
    keep_j = (clear_j > 0.05) & ((d1_j <= 0.85 * d0_j) | (d0_j < 0.5))
    keep = scq.keep_mask(got["clear"], got["d0"], got["d1"], 0.05, 0.85).numpy()
    np.testing.assert_array_equal(keep, keep_j)
    assert 0 < keep.sum() < b
    feat_stats, _ = _jax_c24()
    feat_n = jax_normalize(feat_stats, jax_task.scene_features(cen, rad))
    ctx_j = np.concatenate([np.asarray(jax_normalize(_jax_stats()[1], jnp.asarray(x0_np))),
                            np.asarray(feat_n)], axis=1)
    np.testing.assert_allclose(got["ctx24"].numpy(), ctx_j, rtol=1e-6, atol=1e-6)
    nan_clear = got["clear"].clone()
    nan_clear[0] = float("nan")
    assert not scq.keep_mask(nan_clear, got["d0"], got["d1"], 0.05, 0.85)[0]


N_FT, B_FT = 20, 8


NARROW = dict(state_dim=4, n_support_points=H, unet_input_dim=8, dim_mults=(1, 2),
              context_dim=12)


@pytest.fixture(scope="module")
def widened():
    """A narrow 2-level teacher at the quadrotor's horizon, controls and
    context 12 (``init_like_flax`` from a numpy seed; a JAX train step of a
    3-level U-Net takes ~30 s to compile on the CPU) widened to context 24 by the
    script's step 2, its warm-start gap, and a small dataset of normalized
    plans and contexts from a numpy seed."""
    from mpc_via_diffusion_model_tpu_torch.models import TemporalUnet, init_like_flax
    model12 = init_like_flax(TemporalUnet(**NARROW, cfg_indicator=True),
                             np.random.RandomState(3)).eval()
    model24, err = scq.widened_teacher(model12, "cpu")
    rng = np.random.RandomState(4)
    data = (rng.uniform(-1, 1, (24, H, 4)).astype(np.float32),
            rng.uniform(-1, 1, (24, 24)).astype(np.float32))
    return model24, err, data


def test_finetune_steps_match_jax(widened):
    """The first 20 fine-tune steps of a widened teacher (the script's
    optimizer and the JAX ``make_train_step`` EMA defaults) as one
    ``make_scanned_train_steps`` chunk on the draws that JAX's chunk derives
    from ``PRNGKey(23)``'s first split, staged (indices, then each step's
    loss draws): every loss within 1e-12 and the params and EMA within 1e-9
    of each buffer's largest value, in float64 with the JAX package's
    float32 time embedding on both sides (``test_torch_port_train._x64``)."""
    from test_torch_port_train import _flat, _x64
    model24, err, (u, c) = widened
    assert err < 1e-5
    jm24 = JaxUnet(conditioning_type="default", cfg_indicator=True, **dict(NARROW, context_dim=24))
    with _x64():
        p24 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     scq.to_flax_params(model24))
        opt = jt.make_optimizer(lr=1e-3)
        step_fn = jt.make_train_step(JaxDiffusion(schedule=jax_make_schedule("exponential", 25)),
                                     jm24.apply, opt)

        def run(params, ud, cd, key):
            """The JAX script's fresh state and its first chunk, in one program."""
            state = jt.TrainState(params=params, ema_params=params,
                                  opt_state=opt.init(params), step=jnp.int32(0))
            return _jax_chunk_per_step(step_fn, N_FT)(state, ud, cd, key, B_FT)

        key = jax.random.split(jax.random.PRNGKey(scq.TRAIN_SEED))[1]
        ud, cd = jnp.asarray(u, jnp.float64), jnp.asarray(c, jnp.float64)

        @jax.jit
        def draws(key):
            """Each step's draws as JAX's chunk and loss make them (``_jax_draws``)."""
            def one(kk):
                k_idx, k_loss = jax.random.split(kk)
                idx = jax.random.randint(k_idx, (B_FT,), 0, len(u))
                k_t, k_noise, k_mask = jax.random.split(k_loss, 3)
                return (idx, jax.random.randint(k_t, (B_FT,), 0, 25),
                        jax.random.normal(k_noise, (B_FT, H, 4), jnp.float64),
                        jax.random.bernoulli(k_mask, 0.25, (B_FT, 1)))

            return jax.vmap(one)(jax.random.split(key, N_FT))

        idx, t, noise, mask = (np.asarray(v) for v in draws(key))
        staged = {"idx": torch.from_numpy(idx.astype(np.int64)),
                  "t": torch.from_numpy(t.astype(np.int64)), "noise": torch.from_numpy(noise),
                  "mask": torch.from_numpy(mask.astype(np.float64))}
        jstate, jlosses = jax.jit(run)(p24, ud, cd, key)
        m64 = copy.deepcopy(model24).double()
        from mpc_via_diffusion_model_tpu_torch import train as pt
        from mpc_via_diffusion_model_tpu_torch.core import make_schedule
        from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
        opt_p = pt.make_optimizer(1e-3)
        chunk = pt.make_scanned_train_steps(
            pt.make_train_step(GaussianDiffusion(make_schedule("exponential", 25)), m64, opt_p),
            N_FT)
        state, losses = chunk(scq.new_train_state(m64, opt_p), torch.from_numpy(u).double(),
                              torch.from_numpy(c).double(), B_FT, staged, per_step=True)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-12)
    for name, got, want in (("params", state.params, jstate.params),
                            ("ema", state.ema_params, jstate.ema_params)):
        w = _flat(want, state.layout, None).double()
        assert ((got - w).abs() / w.abs().max()).max().item() < 1e-9, name
    assert int(state.step) == N_FT


def test_student_pickle_is_the_jax_layout(teacher, tmp_path):
    """``save_student`` writes the widened teacher's weights as the JAX
    package pickles them: ``models.load_scene_student`` reads them back
    exactly, and the JAX package's ``TemporalUnet(context 24).apply`` on the
    pickle computes the port's model (1e-5 on seeded inputs)."""
    model24, err = scq.widened_teacher(teacher, "cpu")
    assert err < 1e-5
    scq.save_student(tmp_path / "s.pkl", model24)
    with open(tmp_path / "s.pkl", "rb") as f:
        tree = pickle.load(f)
    assert set(tree) == {"params"}
    back = load_scene_student(tmp_path / "s.pkl", device="cpu")
    for name, v in model24.state_dict().items():
        assert torch.equal(back.state_dict()[name], v), name
    rng = np.random.RandomState(6)
    x = rng.randn(3, H, 4).astype(np.float32)
    t = np.array([0, 11, 24])
    ctx = rng.uniform(-1, 1, (3, 24)).astype(np.float32)
    mask = np.array([[0.0], [1.0], [0.0]], np.float32)
    want = np.asarray(jax.jit(_jax_model(24).apply)(tree, jnp.asarray(x), jnp.asarray(t),
                                                    jnp.asarray(ctx), jnp.asarray(mask)))
    with torch.no_grad():
        got = back(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                   torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _jax_per_row(params, k_cand: int, margin: float, lqr: bool):
    """The JAX script's labeler ``per_row`` (``:205-229``), vmapped and
    jitted; returns the candidates and their scores too."""
    j = _jax_making_parts()
    plant, quad_cost, diffusion = j["plant"], j["quad_cost"], j["diffusion"]
    in_stats = _jax_stats()[0]
    lqr_plan = jax_task.make_lqr_hover_plan(plant, quad_cost, in_stats, H) if lqr else None

    def per_row(x0, cen, rad, key):
        feat = jax_task.scene_features(cen, rad)
        ctx = jax_normalize(j["c24_stats"], jnp.concatenate([x0, feat]))
        plans = diffusion.ddpm_cfg_sample(
            lambda x, t, c, m: j["model24"].apply(params, x, t, c, m), (k_cand, H, 4), key,
            jnp.broadcast_to(ctx[None], (k_cand, 24)), w=gys.W, n_diffusion_steps_without_noise=5)
        if lqr_plan is not None:
            plans = jnp.concatenate([plans, lqr_plan(x0)[None]])

        def score(u_n):
            u = jax_unnormalize(in_stats, jnp.clip(u_n, -1.0, 1.0))
            xs, c = jax_rollout_with_cost(plant, quad_cost, x0, u)
            pen = jnp.maximum(margin - jax_task.min_clearance_jax(xs, centers=cen, radii=rad), 0.0)
            s = c + 1e5 * pen + 1e5 * pen * pen
            return jnp.where(jnp.isfinite(s), s, jnp.inf)

        scores = jax.vmap(score)(plans)
        return plans[jnp.argmin(scores)], plans, scores

    return jax.jit(jax.vmap(per_row))


def test_labeler_matches_jax_per_row_and_a_nan_candidate_loses():
    """``onpolicy_scene.Labeler`` on the committed scene student (the CFG
    chain's plain version) at 2 rows x K = 4 plus the LQR plan, each row in
    its own scene, at a margin of 0.15, against the JAX script's ``per_row``
    on JAX's draws of each row's key: the candidates within rtol = atol =
    1e-4, the scores 1e-4 relative and the same picks where the rollouts are
    well conditioned (the float32 scores within 1e-5 of the float64 ones;
    the LQR plan far from hover saturates and tumbles). Then the script's own
    NaN rule: a NaN candidate never wins (``jnp.argmin`` would pick it), and
    a row whose every score is non-finite takes its first candidate."""
    k_cand, rows, margin = 4, 2, 0.15
    with open(mys_student(), "rb") as f:
        params = pickle.load(f)
    student = load_scene_student(mys_student(), device="cpu")
    x0 = task.eval_start_states(rows, seed=60)
    x0[1, :3] = [0.3, -0.2, 0.1]  # near the goal: the LQR plan competes
    cen, rad = task.sample_scenes(rows, seed=500)
    keys = jax.random.split(jax.random.PRNGKey(400), rows)
    want_lab, want_plans, want_scores = (np.asarray(v) for v in _jax_per_row(
        params, k_cand, margin, True)(jnp.asarray(x0), jnp.asarray(cen), jnp.asarray(rad), keys))
    noise = np.concatenate([_np(jax.random.normal(kk, (gys.T + gys.N_TAIL + 1, k_cand, H, 4)))
                            for kk in keys], axis=1)
    lqr = task.make_lqr_hover_plan(quadrotor(), quadrotor_cost(), scene_stats()[0], H)
    lab = ops.Labeler(scq.pack_unet(student, "cpu"), k_cand, rows, "cpu", margin, lqr)
    t_ = torch.from_numpy
    labels, picks, scores, plans = lab.batch(t_(x0), t_(cen), t_(rad), t_(noise))
    assert plans.shape == (rows, k_cand + 1, H, 4) and lab.chain.plain_calls == 1
    np.testing.assert_allclose(plans.numpy(), want_plans, rtol=TOL, atol=TOL)
    # a saturated plan's 48-step rollout amplifies its last bits: the scores are held where the
    # port's float32 score keeps to its float64 one (1e-5), the picks where a row's all do
    s64 = ops.label_scores(plans.double(), t_(x0).double(), t_(cen), t_(rad), margin)
    calm = ((scores.double() - s64).abs() / s64.abs() < 1e-5).numpy()
    assert calm.sum() >= 8 and calm.all(axis=1).any()
    np.testing.assert_allclose(scores.numpy()[calm], want_scores[calm], rtol=TOL)
    rows_ok = calm.all(axis=1)
    np.testing.assert_array_equal(picks.numpy()[rows_ok], want_scores.argmin(axis=1)[rows_ok])
    np.testing.assert_allclose(labels.numpy()[rows_ok], want_lab[rows_ok], rtol=TOL, atol=TOL)
    s = torch.tensor([[3.0, float("nan"), 1.0, 1.0], [float("nan")] * 2 + [float("inf")] * 2,
                      [float("nan"), 2.0, float("-inf"), 0.0]])
    assert ops.pick(s).tolist() == [2, 0, 3]
    assert int(jnp.argmin(jnp.asarray(s[0].numpy()))) == 1  # the runtime's rule picks the NaN
    nan_plans = plans.clone()
    nan_plans[:, 0] = float("nan")
    nan_scores = ops.label_scores(nan_plans, t_(x0), t_(cen), t_(rad), margin)
    assert not torch.isfinite(nan_scores[:, 0]).any() and (ops.pick(nan_scores) != 0).all()


def mys_student() -> Path:
    return ROOT / "artifacts" / "scene_conditioned" / "scene_student_ema.pkl"


@pytest.mark.parametrize("n_chunks,frac", [(16, 0.5), (4, 0.5), (10, 0.3), (5, 0.0), (3, 1.0)])
def test_onpolicy_slots_match_the_jax_script(n_chunks, frac):
    """The chunks that draw from the on-policy pool: the JAX script's
    ``set(np.round(np.linspace(0, n_chunks - 1, n_onp)))`` (``:333-336``)."""
    n_onp = int(round(frac * n_chunks))
    want = set(np.round(np.linspace(0, n_chunks - 1, n_onp)).astype(int)) if n_onp else set()
    assert ops.onpolicy_slots(n_chunks, frac) == want


def test_paired_gate_passes_jax_and_fails_a_zero_guide(teacher):
    """The paired gates of ``data/guided_yardstick.py``: the JAX package's
    own rows pass, and a zero statistic fails every gate. A guide that
    returns zeros gives it: the held-out protocol's first pairs, the oracle's
    loop with a zero guide against the scene-blind teacher on the same noise
    (one replan, the plain routes), raise no pair's first-plan clearance by
    more than ``RAISE_MIN``, while the real guide does."""
    for gate in gys.PAIRED:
        assert gys.paired_within(gys.PAIRED[gate], gate)
        assert not gys.paired_within({"gain_mean": 0.0, "n_raised": 0}, gate)
    assert set(gys.PAIRED) == {"flagship", "scene0", "heldout_first_plans"}
    assert gys.PAIRED["scene0"] == gys.paired(gys.CLEARANCE_ORACLE, gys.CLEARANCE_BLIND)
    prs = scq.Pairs(gys.N_SCENES, gys.N_STARTS, "cpu")
    sel = torch.tensor([0, 4])  # pairs whose plans pass a sphere
    x0, cen, rad = prs.x0[sel], prs.centers[sel], prs.radii[sel]
    noise = torch.randn((2, 1, gys.T + gys.N_TAIL + 1, 1, H, 4),
                        generator=torch.Generator().manual_seed(0))
    packed = scq.pack_unet(teacher, "cpu")
    from mpc_via_diffusion_model_tpu_torch.scripts import flagship_quadrotor as fq
    from mpc_via_diffusion_model_tpu_torch.scripts import guided_divergence as gdiv
    plans = {}
    for tag in ("zero", "oracle", "blind"):
        if tag == "zero":
            loop, _ = fq.serving_loop(packed, qs.quadrotor_stats(), quadrotor_cost(), 2, 1, "cpu",
                                      guide_builder=lambda x: torch.zeros_like,
                                      t_start_guide=gys.T_START_SCENE)
        else:
            loop, _ = scq.teacher_loop(packed, cen, rad, 1, "cpu", guided=tag == "oracle")
        res = loop(x0, noise)
        plans[tag] = gdiv.plan_clearance(res.x_track[:, 0], res.u_horizons[:, 0], cen, rad)
    zero = gys.paired(plans["zero"], plans["blind"])
    assert zero["n_raised"] == 0 and abs(zero["gain_mean"]) < gys.RAISE_MIN
    assert gys.paired(plans["oracle"], plans["blind"])["n_raised"] >= 1


def test_making_and_onpolicy_scripts_at_toy_size(tmp_path):
    """Both scripts end to end on the CPU at a few rows: ``--make`` fills
    the report's six making keys, writes the student (loaded back by
    ``models.load_scene_student``) and the dataset beside the report, and
    evaluates the made student; ``onpolicy_scene`` chains on that directory
    with the LQR candidate and writes its rows before and after at K = 1
    and K; both refuse an output under ``artifacts/``."""
    out = tmp_path / "made" / "report.json"
    rep = scq.main(["--make", "--cpu", "--n-sample-chunks", "1", "--chunk-rows", "4",
                    "--finetune-steps", "4", "--chunk", "2", "--batch-size", "2",
                    "--eval-scenes", "1", "--eval-starts", "2", "--eval-steps", "1",
                    "--select-k", "2", "--no-teacher-rows", "--out", str(out)])
    for k in ("n_kept", "n_drawn", "sample_seconds", "finetune_steps", "finetune_seconds",
              "final_loss"):
        assert rep[k] is not None, k
    assert rep["n_drawn"] == 4 and rep["finetune_steps"] == 4 and rep["warm_start_max_err"] < 1e-5
    assert len(rep["making"]["first_losses"]) == 4 and rep["making"]["sample_launches"] == 0
    assert set(rep["held_out"]) == {"scene_conditioned_student", "scene_conditioned_student_k2"}
    load_scene_student(out.parent / "scene_student_ema.pkl", device="cpu")
    with np.load(out.parent / "scene_dataset.npz") as z:
        assert z["inputs_normalized"].shape == (rep["n_kept"], H, 4)
        assert z["condition_normalized"].shape == (rep["n_kept"], 24)
    toy = ops.main(["--cpu", "--scene-dir", str(out.parent), "--iterations", "1",
                    "--collect-scenes", "1", "--collect-starts", "2", "--steps", "2",
                    "--label-k", "2", "--lqr-candidate", "--train-steps", "4", "--chunk", "2",
                    "--batch-size", "2", "--eval-scenes", "1", "--eval-starts", "2",
                    "--out", str(tmp_path / "toy")])
    assert [(r["student"], r["K"]) for r in toy["rows"]] == [
        ("before", 1), ("before", 2), ("onpolicy", 1), ("onpolicy", 2)]
    assert toy["iterations"][0]["pairs"] == 4 and toy["iterations"][0]["slots"] == [0]
    assert (tmp_path / "toy" / "scene_student_ema.pkl").exists()
    for main, flag in ((scq.main, "--out"), (ops.main, "--out")):
        with pytest.raises(SystemExit, match="not artifacts/"):
            main(["--cpu", flag, str(ROOT / "artifacts" / "x" / "report.json")])


@pytest.mark.gpu
def test_kernels_at_this_slices_batch_sizes():
    """The U-Net pass kernel at 2 x 2,048 rows on the teacher and the CFG
    chain at 256 x 16 samples on the scene student against their plain
    versions (1e-4, chip_smoke.py's), one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from mpc_via_diffusion_model_tpu_torch.core import make_schedule
    from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import make_fused_cfg_chain
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = load_quadrotor_teacher(gys.TEACHER, device="cuda")
    fu = scq.make_fused_unet(model, 4096, device="cuda")
    x = torch.randn((4096, H, 4), generator=gen, device="cuda")
    t = torch.randint(0, 25, (4096,), generator=gen, device="cuda")
    ctx = torch.rand((4096, 12), generator=gen, device="cuda") * 2 - 1
    mask = (torch.arange(4096, device="cuda") >= 2048).float()[:, None]
    torch.testing.assert_close(fu(x, t, ctx, mask), model(x, t, ctx, mask), atol=1e-4, rtol=0)
    chain = make_fused_cfg_chain(load_scene_student(mys_student(), device="cuda"),
                                 make_schedule("exponential", 25), n_samples=4096, w=0.01,
                                 n_tail=5, device="cuda")
    c = torch.rand((4096, 24), generator=gen, device="cuda") * 2 - 1
    nz = torch.randn((31, 4096, H, 4), generator=gen, device="cuda")
    torch.testing.assert_close(chain(c, nz), chain.plain(c, nz), atol=1e-4, rtol=1e-4)
    assert fu.launches == 1 and chain.launches == 1


@pytest.fixture(scope="module")
def jax_quick(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_quick")
    return jax_making_quick(out), out


@pytest.mark.slow
def test_scene_making_yardstick_regenerates(jax_quick):
    """The JAX package's --quick making half on the CPU gives every literal
    of ``data/scene_making_yardstick.py`` (~5 minutes)."""
    got, _ = jax_quick
    for k, v in mys.MAKING.items():
        assert (tuple(got[k]) if k == "first_losses" else got[k]) == v, k
    assert got["rows"] == mys.METRICS


@pytest.mark.slow
def test_onpolicy_scene_yardstick_regenerates(jax_quick, tmp_path):
    """The JAX package's ``scripts/onpolicy_scene.py`` at the toy size, its
    mixed-in data the JAX making half's, gives every literal of
    ``data/onpolicy_scene_yardstick.py`` (~5 minutes with the making half)."""
    got = jax_onpolicy_toy(jax_quick[1], tmp_path / "toy")
    assert got["pairs"] == [oys.PAIRS]
    assert got["rows"] == oys.METRICS
