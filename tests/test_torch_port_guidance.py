"""Cost-gradient guidance in the port against the JAX package on the CPU:
the guide hooks of ``ddpm_cfg_step``/``ddpm_cfg_sample``, ``ddpm_sample``
with hard conditions, ``ddim_sample`` with CFG, eta and a guide, the
quadrotor's ``make_penalty_grad`` at H = 48 with per-row scenes and a
diverging plan, the guided ``make_closed_loop`` batched over N states
against ``jax.vmap`` of the JAX loop (and its ``ddim`` sampler), the
refusals, ``widen_film_params`` against the JAX script's, the single-state
loop bit for bit against the loop as it was before the batch axis, and the
two scripts on the CPU at a few rows. The yardstick
(``data/guided_yardstick.py``) regenerates under ``slow``; the U-Net pass
kernel at the teacher's shape runs under ``gpu``.

The samplers run a narrow 2-level U-Net carried across by
``from_flax_params`` (H = 8, a 6 + 2-step schedule), the loops the same
widths at the quadrotor's H = 48, 4 controls and context 12. Tolerance:
rtol = atol = 1e-4 unless a test states its own (the JAX suite's for
loops, tests/test_fused_episode.py:157-160). Each JAX draw is handed over
as numpy: the chains' (n_total + 1, *shape), the DDIM sampler's k_init and
k_loop splits, each replan's split of each start's key.
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
from mpc_via_diffusion_model_tpu.control.runtime import make_replan_fn as jax_make_replan_fn
from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.dynamics import get_plant as jax_get_plant
from mpc_via_diffusion_model_tpu.dynamics.base import rollout as jax_rollout
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu_torch.control import make_closed_loop, make_replan_fn
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import guided_yardstick as gys
from mpc_via_diffusion_model_tpu_torch.data import quadrotor_stats as qs
from mpc_via_diffusion_model_tpu_torch.data.normalization import (NormalizerStats, normalize,
                                                                 unnormalize)
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.dynamics import quadrotor, quadrotor_cost
from mpc_via_diffusion_model_tpu_torch.dynamics.base import rollout
from mpc_via_diffusion_model_tpu_torch.dynamics.quadrotor import obstacle_cost
from mpc_via_diffusion_model_tpu_torch.models import (QUADROTOR_TEACHER_CONFIG, TemporalUnet,
                                                      from_flax_params, load_quadrotor_teacher)
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import make_fused_cfg_chain
from mpc_via_diffusion_model_tpu_torch.ops.fused_unet import make_fused_unet
from mpc_via_diffusion_model_tpu_torch.scripts import flagship_quadrotor as fq
from mpc_via_diffusion_model_tpu_torch.scripts import guided_divergence as gdiv
from mpc_via_diffusion_model_tpu_torch.scripts import quadrotor_task as task
from mpc_via_diffusion_model_tpu_torch.scripts import scene_conditioned_quadrotor as scq
from torch_port_util import randomize

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import quadrotor_task as jax_task  # noqa: E402  (the JAX package's task, top-level scripts/)
import scene_conditioned_quadrotor as jax_scene  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-4
T, N_TAIL = 6, 2
NARROW = dict(unet_input_dim=8, dim_mults=(1, 2), cfg_indicator=True)


def _models(seed: int, **cfg):
    """(flax model, numpy params, torch model) of a narrow 2-level U-Net."""
    cfg = dict(NARROW, **cfg)
    jm = JaxUnet(conditioning_type="default", **cfg)
    h, d, c = cfg["n_support_points"], cfg["state_dim"], cfg["context_dim"]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, h, d)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, c)), jnp.zeros((1, 1)))
    params = randomize(shapes, seed)
    tm = TemporalUnet(**cfg)
    tm.load_state_dict(from_flax_params(params))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def small():
    return _models(3, state_dim=2, n_support_points=8, context_dim=3)


@pytest.fixture(scope="module")
def quad():
    """The narrow U-Net at the quadrotor's widths: H = 48, 4 controls, context 12."""
    return _models(5, state_dim=4, n_support_points=48, context_dim=12)


def _denoisers(jm, params, tm):
    """The same masked denoiser in both frameworks (a zero mask for None)."""
    def jfn(x, t, c, m):
        return jm.apply(params, x, t, c, jnp.zeros((x.shape[0], 1)) if m is None else m)

    def tfn(x, t, c, m):
        return tm(x, t, c, torch.zeros((x.shape[0], 1)) if m is None else m)

    return jfn, tfn


def _guides(scale: float = 0.05):
    """A smooth closed-form guide in both frameworks."""
    return (lambda x: -scale * jnp.tanh(x - 0.2)), (lambda x: -scale * torch.tanh(x - 0.2))


def _np(x):
    return np.array(x, np.float32)


@pytest.mark.parametrize("scale_grad_by_std", [False, True])
def test_guided_ddpm_cfg_sample_matches_jax(small, scale_grad_by_std):
    """Two guide steps per step, the window cut mid-chain (i < 3.5 of
    5..-2), every x of the chain; one step of ``ddpm_cfg_step`` alone too."""
    jm, params, tm = small
    jfn, tfn = _denoisers(jm, params, tm)
    jg, tg = _guides()
    ctx = np.random.RandomState(0).uniform(-1, 1, (3, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    kw = dict(w=0.3, n_diffusion_steps_without_noise=N_TAIL, n_guide_steps=2, t_start_guide=3.5,
              scale_grad_by_std=scale_grad_by_std)
    want_x, want_chain = jax.jit(lambda k, c: JaxDiffusion(
        schedule=jax_make_schedule("exponential", T)).ddpm_cfg_sample(
            jfn, (3, 8, 2), k, c, return_chain=True, guide=jg, **kw))(key, jnp.asarray(ctx))
    noise = torch.from_numpy(_np(jax.random.normal(key, (T + N_TAIL + 1, 3, 8, 2))))
    diff = GaussianDiffusion(make_schedule("exponential", T))
    got_x, got_chain = diff.ddpm_cfg_sample(tfn, (3, 8, 2), torch.from_numpy(ctx), noise=noise,
                                            return_chain=True, guide=tg, **kw)
    assert got_chain.shape == (T + N_TAIL + 1, 3, 8, 2)
    np.testing.assert_allclose(got_chain.numpy(), _np(want_chain), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_x.numpy(), _np(want_x), rtol=TOL, atol=TOL)
    plain = diff.ddpm_cfg_sample(tfn, (3, 8, 2), torch.from_numpy(ctx), w=0.3,
                                 n_diffusion_steps_without_noise=N_TAIL, noise=noise)
    assert (plain - got_x).abs().max() > 1e-4  # the guide acted
    step = jax.jit(lambda x_, n_, c_: JaxDiffusion(
        schedule=jax_make_schedule("exponential", T)).ddpm_cfg_step(
            jfn, x_, jnp.int32(2), n_, c_, 0.3, guide=jg, n_guide_steps=2, t_start_guide=3.5,
            scale_grad_by_std=scale_grad_by_std))(want_chain[3], jnp.asarray(noise[4].numpy()),
                                                   jnp.asarray(ctx))
    with torch.no_grad():
        got_step = diff.ddpm_cfg_step(tfn, torch.from_numpy(_np(want_chain[3])), 2, noise[4],
                                      torch.from_numpy(ctx), 0.3, guide=tg, n_guide_steps=2,
                                      t_start_guide=3.5, scale_grad_by_std=scale_grad_by_std)
    np.testing.assert_allclose(got_step.numpy(), _np(step), rtol=TOL, atol=TOL)


def test_ddpm_sample_with_hard_conds_and_guide_matches_jax(small):
    """The plain DDPM sampler: hard conditions on the first and last rows,
    a std-scaled guide twice per step from i < 4, an extra noise schedule."""
    jm, params, tm = small
    jfn, tfn = _denoisers(jm, params, tm)
    jg, tg = _guides(0.1)
    rng = np.random.RandomState(1)
    ctx = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    idx, vals = np.array([0, 7]), rng.uniform(-0.5, 0.5, (2, 2, 2)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    kw = dict(n_diffusion_steps_without_noise=N_TAIL, n_guide_steps=2, t_start_guide=4.0,
              scale_grad_by_std=True, noise_std_extra_schedule_fn=lambda i: 1.0 - 0.05 * i,
              return_chain=True)
    want_x, want_chain = jax.jit(lambda k, c: JaxDiffusion(
        schedule=jax_make_schedule("exponential", T)).ddpm_sample(
            jfn, (2, 8, 2), k, c, (jnp.asarray(idx), jnp.asarray(vals)), guide=jg, **kw))(
        key, jnp.asarray(ctx))
    noise = torch.from_numpy(_np(jax.random.normal(key, (T + N_TAIL + 1, 2, 8, 2))))
    got_x, got_chain = GaussianDiffusion(make_schedule("exponential", T)).ddpm_sample(
        tfn, (2, 8, 2), torch.from_numpy(ctx), (torch.from_numpy(idx), torch.from_numpy(vals)),
        guide=tg, noise=noise, **kw)
    np.testing.assert_allclose(got_chain.numpy(), _np(want_chain), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got_x[:, idx].numpy(), vals)


@pytest.mark.parametrize("w,eta,hard", [(0.3, 0.5, False), (0.0, 0.0, True)])
def test_ddim_sample_matches_jax(small, w, eta, hard):
    """CFG-DDIM (no clip, epsilon re-derived) with eta > 0, or the
    conditional pass alone with hard conditions; a guide on time_next < 8
    of the 3-step grid of T = 30 (29, 19, 10, 0); x_init and each pair's
    noise from JAX's splits."""
    jm, params, tm = small
    jfn, tfn = _denoisers(jm, params, tm)
    jg, tg = _guides(0.2)
    rng = np.random.RandomState(2)
    ctx = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    idx, vals = np.array([0]), rng.uniform(-0.5, 0.5, (2, 1, 2)).astype(np.float32)
    t_total, n_sample = 30, 3
    key = jax.random.PRNGKey(4)
    want_x, want_chain = jax.jit(lambda k, c: JaxDiffusion(
        schedule=jax_make_schedule("exponential", t_total)).ddim_sample(
            jfn, (2, 8, 2), k, c, (jnp.asarray(idx), jnp.asarray(vals)) if hard else None,
            sampling_timesteps=n_sample, eta=eta, w=w, guide=jg, t_start_guide=8.0,
            return_chain=True))(key, jnp.asarray(ctx))
    k_init, k_loop = jax.random.split(key)
    draws = [jax.random.normal(k_init, (2, 8, 2))]
    for _ in range(n_sample):
        k_loop, k_noise = jax.random.split(k_loop)
        draws.append(jax.random.normal(k_noise, (2, 8, 2)))
    got_x, got_chain = GaussianDiffusion(make_schedule("exponential", t_total)).ddim_sample(
        tfn, (2, 8, 2), torch.from_numpy(ctx),
        (torch.from_numpy(idx), torch.from_numpy(vals)) if hard else None,
        sampling_timesteps=n_sample, eta=eta, w=w, guide=tg, t_start_guide=8.0,
        return_chain=True, noise=torch.from_numpy(_np(jnp.stack(draws))))
    assert got_chain.shape == (n_sample + 2, 2, 8, 2)
    np.testing.assert_allclose(got_chain.numpy(), _np(want_chain), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_x.numpy(), _np(want_x), rtol=TOL, atol=TOL)


def _jax_stats():
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    return (JaxStats("limits", f32(qs.INPUTS_MINS), f32(qs.INPUTS_MAXS)),
            JaxStats("limits", f32(qs.CONDITION_MINS), f32(qs.CONDITION_MAXS)))


def test_penalty_grad_matches_jax_with_row_scenes_and_a_diverging_plan():
    """``make_penalty_grad`` at H = 48 on the real quadrotor against the JAX
    task's per plan under ``vmap`` (one jitted JAX function for every case):
    hover-like plans from three states, two plans each, one state spinning
    at thousands of rad/s so that its rollout overflows and its gradient is
    non-finite (both set it to 0); per-row scenes, then the canonical scene
    through ``make_loop_guide_builder`` from the three states (row j from
    state j // 2) and from one shared state. Per-row scenes in
    ``obstacle_cost`` equal one scene at a time, and ``min_clearance_torch``
    the JAX task's ``min_clearance_jax``.

    The gradient of a 48-step rollout is ill-conditioned in places: deep in
    a sphere, or where the rollout nears tan(theta)'s pole, float32 parts
    from float64 by up to 1e-3, or flips a clamp, in both frameworks alike.
    The states lie where it is not, and the test checks that: the port's
    float32 step within 5e-5 of its float64 step (the same code on
    float64 tensors)."""
    rng = np.random.RandomState(3)
    ins = qs.quadrotor_stats()[0]
    hover = normalize(ins, torch.tensor([task.HOVER_THRUST, 0.0, 0.0, 0.0])).numpy()
    u = (hover + 0.05 * rng.randn(6, 48, 4)).astype(np.float32)
    states = np.zeros((3, 12), np.float32)
    states[:, :3] = [[0.9, 0.5, 1.2], [1.5, 0.4, 1.1], [2.0, 0.0, 1.0]]
    states[2, 9:12] = [3e3, -2e3, 1e3]  # diverges
    rows = np.repeat(states, 2, axis=0)
    c, r = task.sample_scenes(6, seed=3)
    canon = (np.repeat(task.OBS_CENTERS[None], 6, axis=0), np.repeat(task.OBS_RADII[None], 6, 0))
    jplant, _ = jax_get_plant("quadrotor")
    jper = jax.jit(jax.vmap(jax_task.make_penalty_grad(jplant, _jax_stats()[0], 0.1,
                                                       scene_args=True)))
    jx = lambda *a: np.asarray(jper(*(jnp.asarray(v) for v in a)))
    t_ = torch.from_numpy
    per = task.make_penalty_grad(quadrotor(), ins, 0.1, scene_args=True)
    per64 = task.make_penalty_grad(quadrotor(), NormalizerStats("limits", ins.mins.double(),
                                                               ins.maxs.double()), 0.1, True)
    for x, cc, rr in ((rows, c, r), (rows, *canon), (np.repeat(states[:1], 6, 0), *canon)):
        gap = per(t_(u), t_(x), t_(cc), t_(rr)).double() - per64(
            *(t_(a).double() for a in (u, x, cc, rr)))
        assert gap.abs().max() < 5e-5
    got = per(t_(u), t_(rows), t_(c), t_(r))
    want = jx(u, rows, c, r)
    assert torch.isfinite(got).all() and not got.requires_grad
    assert np.abs(want[:4]).max() > 1e-3 and not want[4:].any() and not got[4:].any()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    with torch.enable_grad():  # the overflowing plans' own gradient is not finite
        un = t_(u[4:]).requires_grad_(True)
        pen = obstacle_cost(rollout(quadrotor(), t_(rows[4:]), unnormalize(ins, un)), t_(c[4:]),
                            t_(r[4:])).sum()
        assert not torch.isfinite(torch.autograd.grad(pen, un)[0]).all()
    builder = task.make_loop_guide_builder(quadrotor(), ins, 0.1)
    np.testing.assert_allclose(builder(t_(states))(t_(u)).numpy(), jx(u, rows, *canon),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(builder(t_(states[0]))(t_(u)).numpy(),
                               jx(u, np.repeat(states[:1], 6, axis=0), *canon),
                               rtol=TOL, atol=TOL)
    traj = t_(rng.uniform(0, 2, (6, 7, 12)).astype(np.float32))
    per_row = obstacle_cost(traj, t_(c), t_(r))
    for i in range(6):
        assert torch.equal(per_row[i], obstacle_cost(traj[i], t_(c[i]), t_(r[i])))
        assert task.min_clearance_torch(traj[i], c[i], r[i]).item() == pytest.approx(
            float(jax_task.min_clearance_jax(jnp.asarray(traj[i].numpy()), c[i], r[i])),
            abs=1e-6)
    np.testing.assert_allclose(task.min_clearance_torch(traj).numpy(),
                               task.min_clearance(traj.numpy()), atol=1e-6)


N_LOOP = 3


def _jax_start_noise(keys, k: int, n_rows: int) -> np.ndarray:
    """(N, n_steps, n_rows, K, 48, 4): each start's replan keys split from
    its key, each replan's draw as the JAX sampler makes it (one program)."""
    draw = jax.jit(jax.vmap(lambda key: jax.vmap(
        lambda kk: jax.random.normal(kk, (n_rows, k, 48, 4)))(jax.random.split(key, N_LOOP))))
    return _np(draw(keys))


def _starts(n: int) -> np.ndarray:
    """The flagship's first n eval starts (seed 7)."""
    return task.eval_start_states(n, seed=7)


@pytest.fixture(scope="module")
def teacher():
    """The quadrotor teacher in both frameworks: the guided loop needs a
    trained model, whose plans roll the quadrotor smoothly (a random
    model's saturate it, and a 48-step rollout's gradient turns fp32
    rounding into O(1) differences)."""
    with open(gys.TEACHER, "rb") as f:
        params = pickle.load(f)
    jm = JaxUnet(conditioning_type="default", cfg_indicator=True, **QUADROTOR_TEACHER_CONFIG)
    return jm, params, fq.teacher("cpu")


@pytest.fixture(scope="module")
def jax_guided(teacher):
    """``jax.vmap`` of the JAX package's guided flagship loop (T = 25 + 5,
    the guide on i < 12.5) over 3 starts, N_LOOP replans, and its draws."""
    jm, params, _ = teacher
    j_ins, j_cond = _jax_stats()
    jplant, jqcost = jax_get_plant("quadrotor")
    jloop = jax_closed_loop(JaxDiffusion(schedule=jax_make_schedule("exponential", gys.T)),
                            jm.apply, j_ins, j_cond, jplant, jax_task.make_task_cost(jqcost),
                            horizon=48, n_steps=N_LOOP, w=gys.W,
                            n_diffusion_steps_without_noise=gys.N_TAIL,
                            guide_builder=jax_task.make_loop_guide_builder(jplant, j_ins, 0.1),
                            n_guide_steps=1, t_start_guide=gys.T_START_FLAGSHIP)
    x0 = _starts(3)
    keys = jax.random.split(jax.random.PRNGKey(13), 3)
    want = jax.jit(jax.vmap(lambda x, k: jloop(params, x, k)))(jnp.asarray(x0), keys)
    return x0, torch.from_numpy(_jax_start_noise(keys, 1, gys.T + gys.N_TAIL + 1)), want


@pytest.mark.parametrize("n", [1, 3])
def test_guided_closed_loop_matches_jax_vmap(teacher, jax_guided, n):
    """The flagship script's guided loop (``flagship_quadrotor.flagship_loop``:
    the U-Net pass wrapper's plain version on the CPU, the task cost, the
    guide on i < 12.5) over N states against ``jax.vmap`` of the JAX loop
    on its own draws; N = 1 as a single state (n,), and then the guide
    moved the plans against the unguided loop on the same draws."""
    x0, noise, want = jax_guided
    loop, route = fq.flagship_loop(teacher[2], True, n, N_LOOP, "cpu")
    got = loop(torch.from_numpy(x0[0]), noise[0]) if n == 1 else loop(torch.from_numpy(x0),
                                                                      noise)
    assert route.plain_calls == N_LOOP * (gys.T + gys.N_TAIL)
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        w_ = _np(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w_[0] if n == 1 else w_,
                                   rtol=TOL, atol=TOL, err_msg=name)
    if n == 1:
        plain, _ = fq.flagship_loop(teacher[2], False, 1, N_LOOP, "cpu")
        moved = plain(torch.from_numpy(x0[0]), noise[0]).u_horizons - got.u_horizons
        assert moved.abs().max() > 1e-3


def test_ddim_sampler_closed_loop_matches_jax_vmap(quad):
    """``sampler='ddim'`` (the zero mask, CFG-DDIM at w = 0.01 over the
    5-step grid of T = 25) over 2 states against ``jax.vmap`` of the JAX
    loop, on the narrow U-Net at the quadrotor's widths (K = 1: a random
    model's plans roll the quadrotor chaotically, so best-of-K scores would
    tie-break on rounding)."""
    jm, params, tm = quad
    j_ins, j_cond = _jax_stats()
    jplant, jqcost = jax_get_plant("quadrotor")
    ins, cond = qs.quadrotor_stats()
    kw = dict(horizon=48, n_steps=N_LOOP, w=0.01, sampler="ddim")
    jloop = jax_closed_loop(JaxDiffusion(schedule=jax_make_schedule("exponential", 25)), jm.apply,
                            j_ins, j_cond, jplant, jax_task.make_task_cost(jqcost), **kw)
    loop = make_closed_loop(GaussianDiffusion(make_schedule("exponential", 25)), tm, ins, cond,
                            quadrotor(), task.make_task_cost(quadrotor_cost()), device="cpu",
                            **kw)
    x0 = _starts(2)
    keys = jax.random.split(jax.random.PRNGKey(17), 2)
    want = jax.jit(jax.vmap(lambda x, k: jloop(params, x, k)))(jnp.asarray(x0), keys)
    noise = []
    for key in keys:
        per = []
        for kr in jax.random.split(key, N_LOOP):
            k_init, k_loop = jax.random.split(kr)
            draws = [jax.random.normal(k_init, (1, 48, 4))]
            for _ in range(5):
                k_loop, k_noise = jax.random.split(k_loop)
                draws.append(jax.random.normal(k_noise, (1, 48, 4)))
            per.append(_np(jnp.stack(draws)))
        noise.append(np.stack(per))
    got = loop(torch.from_numpy(x0), torch.from_numpy(np.stack(noise)))
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), _np(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_guide_refusals(quad):
    """A guide cannot compose with ``sample_override`` (the JAX runtime's
    ValueError), nor is there a third sampler; a batched loop checks its
    noise against (N, n_steps, ...)."""
    _, _, tm = quad
    ins, cond = qs.quadrotor_stats()
    diff = GaussianDiffusion(make_schedule("exponential", T))
    chain = make_fused_cfg_chain(tm, make_schedule("exponential", T), n_samples=1, w=0.01,
                                 n_tail=N_TAIL, device="cpu")
    gb = task.make_loop_guide_builder(quadrotor(), ins, 0.1)
    with pytest.raises(ValueError, match="cannot compose with sample_override"):
        make_replan_fn(diff, tm, ins, cond, 48, 4, guide_builder=gb, sample_override=chain)
    with pytest.raises(ValueError, match="cannot compose with sample_override"):
        make_closed_loop(diff, tm, ins, cond, quadrotor(), quadrotor_cost(), 48,
                         guide_builder=gb, sample_override=chain, device="cpu")
    with pytest.raises(ValueError, match="unknown sampler"):
        make_replan_fn(diff, tm, ins, cond, 48, 4, sampler="dpm")
    loop = make_closed_loop(diff, tm, ins, cond, quadrotor(), quadrotor_cost(), 48, n_steps=1,
                            n_diffusion_steps_without_noise=N_TAIL, device="cpu")
    with pytest.raises(ValueError, match="noise must be"):
        loop(torch.zeros((2, 12)), torch.zeros((1, T + N_TAIL + 1, 1, 48, 4)))


def _parent_loop(diffusion, denoise, ins, cond, plant, cost, k, n_steps):
    """The per-replan loop as it was before the batch axis and the guide
    (one state, ``ddpm_cfg_sample`` or best-of-K over the whole rollout)."""
    def replan(x0, noise):
        ctx = normalize(cond, x0)[None, :].expand(k, 12)
        u_cand = unnormalize(ins, diffusion.ddpm_cfg_sample(
            denoise, (k, 48, 4), ctx, w=0.01, n_diffusion_steps_without_noise=N_TAIL,
            noise=noise))
        if k == 1:
            return u_cand[0]
        x, acc = x0.expand(k, 12), torch.zeros((k,))
        for i in range(48):
            acc = acc + cost.stage(x, u_cand[:, i, :])
            x = plant.step(x, u_cand[:, i, :])
        return u_cand[torch.argmin(acc + cost.terminal(x))]

    def loop(x, noise):
        xs, us, stages = [x], [], []
        for i in range(n_steps):
            u0 = replan(x, noise[i])[0]
            stages.append(cost.stage(x, u0))
            x = plant.step(x, u0)
            xs.append(x)
            us.append(u0)
        return torch.stack(xs), torch.stack(us), torch.stack(stages)

    return torch.no_grad()(loop)


@pytest.mark.parametrize("k", [1, 3])
def test_single_state_loop_is_bit_equal_to_the_parents(quad, k):
    """One state (n,) through the batched loop gives exactly the bits of
    the loop before the batch axis, at K = 1 and best-of-3."""
    _, _, tm = quad
    ins, cond = qs.quadrotor_stats()
    diff = GaussianDiffusion(make_schedule("exponential", T))
    cost = task.make_select_cost(quadrotor_cost())
    loop = make_closed_loop(diff, tm, ins, cond, quadrotor(), cost, 48, n_steps=2,
                            n_diffusion_steps_without_noise=N_TAIL, n_candidates=k, device="cpu")
    noise = torch.randn((2, T + N_TAIL + 1, k, 48, 4), generator=torch.Generator().manual_seed(k))
    x0 = torch.from_numpy(_starts(1)[0])
    got = loop(x0, noise)
    xs, us, stages = _parent_loop(diff, tm, ins, cond, quadrotor(), cost, k, 2)(x0, noise)
    assert torch.equal(got.x_track, xs) and torch.equal(got.u_track, us)
    assert torch.equal(got.stage_costs, stages)


def test_widen_film_params_matches_jax_script():
    """``widen_film_params`` on torch state dicts against the JAX script's
    on flax trees (context 12 -> 24, a narrow H = 48 U-Net): equal, and the
    widened model computes the teacher's function on the probe."""
    jm12, p12, tm12 = _models(11, state_dim=4, n_support_points=48, context_dim=12)
    jm24, p24, tm24 = _models(12, state_dim=4, n_support_points=48, context_dim=24)
    want = from_flax_params(jax_scene.widen_film_params(p12, p24, 12, 24, cfg_indicator=True))
    got = scq.widen_film_params(tm12.state_dict(), tm24.state_dict(), 12, 24, cfg_indicator=True)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    tm24.load_state_dict(got)
    assert scq.warm_start_error(tm12, tm24) < 1e-5
    with pytest.raises(ValueError, match="unexpected widened"):
        scq.widen_film_params(tm12.state_dict(), tm24.state_dict(), 12, 20, cfg_indicator=True)


def test_scripts_run_on_the_cpu_and_refuse(tmp_path):
    """Both scripts at a few rows and one replan on the CPU (the plain
    versions of the kernels), their reports outside ``artifacts/``, the
    scene study's making keys None without ``--make`` (its making half:
    ``test_torch_port_scene_making.py``), and the refusals of the flagship's
    halves that wait (ROADMAP.md A6)."""
    out = fq.main(["--eval-starts", "2", "--steps", "1", "--no-rates", "--device", "cpu",
                   "--out", str(tmp_path / "f.json")])
    assert out["guided"]["within_yardstick"] is None and out["guided"]["kernel"] == "fused_unet"
    assert out["guided"]["collision_free_fraction"] == 1.0 and "cost_mean" in out["unguided"]
    rep = scq.main(["--eval-scenes", "2", "--eval-starts", "2", "--eval-steps", "1",
                    "--select-k", "2", "--device", "cpu", "--out", str(tmp_path / "s.json")])
    assert set(rep["held_out"]) == {"teacher_scene_blind", "teacher_per_scene_guided_oracle",
                                    "scene_conditioned_student", "scene_conditioned_student_k2"}
    assert len(rep["held_out"]["teacher_scene_blind"]["per_scene_cf"]) == 2
    assert rep["warm_start_max_err"] < 1e-5
    assert rep["scene0_yardstick"]["teacher_per_scene_guided_oracle"]["within_yardstick"] is None
    assert rep["n_kept"] is None and rep["final_loss"] is None and rep["making"] is None
    assert out["paired_gate"]["within"] is None
    for main, flag, item in ((fq.main, "--collect", "A6"), (fq.main, "--expert", "A6")):
        with pytest.raises(SystemExit, match=item):
            main([flag, "--device", "cpu"])
    with pytest.raises(SystemExit, match="not artifacts/"):
        fq.main(["--device", "cpu", "--out", str(ROOT / "artifacts" / "flagship_quadrotor" /
                                                 "report.json")])
    for row in gys.ROWS:
        assert set(gys.BOUNDS[row]) == set(gys.METRICS[row]) and gys.within(gys.METRICS[row], row)
        assert all(gys.BOUNDS[row][m] >= 2 / 16 for m in gys.METRICS[row]
                   if m.endswith("fraction"))


@pytest.mark.gpu
def test_fused_unet_kernel_matches_plain_at_the_teachers_shape():
    """The U-Net pass kernel on the quadrotor teacher (H = 48, context 12) at
    batch 2 and 32 against ``TemporalUnet``: 1e-4, chip_smoke.py's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    model = load_quadrotor_teacher(gys.TEACHER, device="cuda")
    rng = np.random.RandomState(0)
    for b in (2, 32):
        fused = make_fused_unet(model, batch_size=b, device="cuda")
        x = torch.from_numpy(rng.randn(b, 48, 4).astype(np.float32)).cuda()
        t = torch.from_numpy(rng.randint(0, T, b)).cuda()
        ctx = torch.from_numpy(rng.uniform(-1, 1, (b, 12)).astype(np.float32)).cuda()
        mask = torch.from_numpy((np.arange(b) % 2)[:, None].astype(np.float32)).cuda()
        got = fused(x, t, ctx, mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, model(x, t, ctx, mask), atol=1e-4, rtol=0)
        assert fused.launches == 1


@pytest.mark.slow
def test_guided_yardstick_regenerates():
    """The JAX package's four rows on the CPU give every literal of (a) and
    (b) of data/guided_yardstick.py, and the JAX package's values of its
    paired gates (d) (~3.5 minutes)."""
    with open(gys.TEACHER, "rb") as f:
        params = pickle.load(f)
    jm = JaxUnet(conditioning_type="default", cfg_indicator=True, **QUADROTOR_TEACHER_CONFIG)
    ins, cond = _jax_stats()
    jplant, jqcost = jax_get_plant("quadrotor")
    diffusion = JaxDiffusion(schedule=jax_make_schedule("exponential", gys.T))
    kw = dict(horizon=48, n_steps=gys.N_STEPS, w=gys.W, n_diffusion_steps_without_noise=gys.N_TAIL)
    c0, r0 = (a[0] for a in jax_task.sample_scenes(gys.N_SCENES, seed=gys.SCENE_SEED))
    for row in gys.ROWS:
        if row in ("guided", "unguided"):
            gb = jax_task.make_loop_guide_builder(jplant, ins, gys.GUIDE_SCALE)
            loop = jax_closed_loop(diffusion, jm.apply, ins, cond, jplant,
                                   jax_task.make_task_cost(jqcost), **kw,
                                   guide_builder=gb if row == "guided" else None,
                                   n_guide_steps=1, t_start_guide=gys.T_START_FLAGSHIP)
            x0 = jnp.asarray(jax_task.eval_start_states(gys.N_STARTS, gys.FLAGSHIP_START_SEED))
            keys = jax.random.split(jax.random.PRNGKey(gys.FLAGSHIP_KEY_SEED), gys.N_STARTS)
            runs = jax.jit(jax.vmap(lambda x, k: loop(params, x, k)))(x0, keys)
            xt, c, r = np.asarray(runs.x_track), None, None
            metrics = jax_task.track_metrics(xt, runs.stage_costs)
        else:
            x0 = jnp.asarray(jax_task.eval_start_states(gys.N_STARTS, seed=gys.SCENE_START_SEED))
            keys = jax.random.split(jax.random.PRNGKey(gys.SCENE_KEY_SEED),
                                    gys.N_SCENES * gys.N_STARTS)[:gys.N_STARTS]
            pc = jnp.asarray(np.repeat(c0[None], gys.N_STARTS, axis=0))
            pr = jnp.asarray(np.repeat(r0[None], gys.N_STARTS, axis=0))
            per_grad = jax_task.make_penalty_grad(jplant, ins, gys.GUIDE_SCALE, scene_args=True)

            def run(cen, rad, x, k, guided=row == "oracle"):
                def guide_builder(xc):
                    return lambda u: jax.vmap(lambda uu: per_grad(uu, xc, cen, rad))(u)

                loop = jax_closed_loop(diffusion, jm.apply, ins, cond, jplant, jqcost, **kw,
                                       guide_builder=guide_builder if guided else None,
                                       n_guide_steps=1, t_start_guide=gys.T_START_SCENE)
                return loop(params, x, k)

            runs = jax.jit(jax.vmap(run))(pc, pr, x0, keys)
            xt, c, r = np.asarray(runs.x_track), c0, r0
            metrics = jax_task.track_metrics(xt, centers=c, radii=r)
        assert metrics == gys.METRICS[row], row
        assert tuple(float(v) for v in jax_task.min_clearance(xt, c, r)) == getattr(
            gys, f"CLEARANCE_{row.upper()}")
        assert tuple(float(v) for v in np.linalg.norm(xt[:, -1, :3], axis=-1)) == getattr(
            gys, f"GOAL_DIST_{row.upper()}")
    for gate, (a, b) in gys.PAIRS.items():  # (d): the paired gates of the rows above
        assert gys.PAIRED[gate] == gys.paired(getattr(gys, f"CLEARANCE_{a.upper()}"),
                                              getattr(gys, f"CLEARANCE_{b.upper()}"))
    # (d): the held-out protocol's first plans, the oracle against the blind teacher, each
    # pair's first replan key the first of its key's split into N_STEPS, as the loop splits it
    E, S = gys.N_SCENES, gys.N_STARTS
    ev_c, ev_r = jax_task.sample_scenes(E, seed=gys.SCENE_SEED)
    starts = jnp.asarray(jax_task.eval_start_states(S, seed=gys.SCENE_START_SEED))
    pc, pr = jnp.repeat(jnp.asarray(ev_c), S, axis=0), jnp.repeat(jnp.asarray(ev_r), S, axis=0)
    pk = jax.random.split(jax.random.PRNGKey(gys.SCENE_KEY_SEED), E * S)
    per_grad = jax_task.make_penalty_grad(jplant, ins, gys.GUIDE_SCALE, scene_args=True)
    first = {}
    for row in ("oracle", "blind"):
        def first_plan(cen, rad, x, k, guided=row == "oracle"):
            def guide_builder(xc):
                return lambda u: jax.vmap(lambda uu: per_grad(uu, xc, cen, rad))(u)

            replan = jax_make_replan_fn(diffusion, jm.apply, ins, cond, 48, 4, gys.W, gys.N_TAIL,
                                        1, jplant, jqcost,
                                        guide_builder=guide_builder if guided else None,
                                        n_guide_steps=1, t_start_guide=gys.T_START_SCENE)
            u_hor, _ = replan(params, x, jax.random.split(k, gys.N_STEPS)[0])
            return jax_task.min_clearance_jax(jax_rollout(jplant, x, u_hor), cen, rad)

        first[row] = np.asarray(jax.jit(jax.vmap(first_plan))(pc, pr, jnp.tile(starts, (E, 1)), pk))
    assert gys.paired(first["oracle"], first["blind"]) == gys.PAIRED["heldout_first_plans"]


def test_divergence_runs_the_scripts_loops():
    """``scripts/guided_divergence.py`` at one replan: the study's scene 0
    of the 8-scene draw (not of a 1-scene draw), the rows' starts, and a
    metrics row for each of the four rows."""
    c, r = gdiv.scene0()
    np.testing.assert_array_equal(c, task.sample_scenes(8, seed=99)[0][0])
    assert not np.array_equal(c, task.sample_scenes(1, seed=99)[0][0])
    packed = fq.teacher("cpu")
    for row in ("oracle", "unguided"):
        met = gdiv.run(packed, row, 0, gdiv.starts(row)[:2], n_steps=1)
        assert set(gys.METRICS[row]) <= set(met)
