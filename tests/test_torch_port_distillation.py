"""The port's distilled-student sampler (diffusion/distillation.py), the
collection cost the students are scored with and ``load_student``, against
the JAX package; and the students' teacher statistics (data/teacher_stats.py).

The DDIM tables are computed in float64 from the same float32 schedule and
cast to float32 on both sides, so they agree exactly. The samplers compare
at 1e-4, the JAX suite's chain tolerance (tests/test_fused_denoise.py): one
fp32 U-Net forward per step, summed in other orders. The student's forward
compares at 1e-5: one forward of the real weights. The x_init is JAX's own
draw, ``jax.random.normal(key, shape)``, handed over as numpy.
"""
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.diffusion import distillation as jax_dist
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu.models import UNET_DIM_MULTS
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu.ops.fused_denoise import make_fused_ddim_chain as jax_ddim_chain
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import normalize
from mpc_via_diffusion_model_tpu_torch.data import teacher_stats as ts
from mpc_via_diffusion_model_tpu_torch.data.teacher_stats import teacher_stats
from mpc_via_diffusion_model_tpu_torch.diffusion import (ddim_affine_coefs, ddim_time_grid,
                                                         halve_times, make_student_ddim_sampler)
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_collect_cost,
                                                        theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.models import FLAGSHIP_CONFIG, load_student
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import make_fused_ddim_chain
from torch_port_util import SMALL, small_models

STUDENT = (Path(__file__).resolve().parents[1] / "artifacts" / "onpolicy_cartpole"
           / "student_1eval.pkl")
TOL = 1e-4
H = SMALL["n_support_points"]


@pytest.mark.parametrize("kind,n_steps,times", [
    ("exponential", 25, [23]), ("exponential", 25, [23, 15, 7]),
    ("linear", 4, ddim_time_grid(4)), ("exponential", 25, ddim_time_grid(25, 23))])
def test_ddim_tables_equal_jax(kind, n_steps, times):
    got = ddim_affine_coefs(make_schedule(kind, n_steps), times)
    want = jax_dist.ddim_affine_coefs(jax_make_schedule(kind, n_steps), times)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == np.asarray(want[name]).dtype, name
        np.testing.assert_array_equal(got[name], np.asarray(want[name]), err_msg=name)
    if times == [23]:  # the 1-eval student: one recon step, no affine update
        assert (got["c1"][0], got["c2"][0]) == (1.0, 0.0)


@pytest.mark.parametrize("n_steps,t_start", [(25, None), (25, 23), (4, None), (1, None)])
def test_time_grids_equal_jax(n_steps, t_start):
    """The finest grid and every coarsening by halving, down to one step."""
    grid, jgrid = ddim_time_grid(n_steps, t_start), jax_dist.ddim_time_grid(n_steps, t_start)
    assert grid == jgrid
    while len(grid) > 1:
        grid, jgrid = halve_times(grid), jax_dist.halve_times(jgrid)
        assert grid == jgrid


@pytest.fixture(scope="module")
def small():
    return small_models(seed=61)


@pytest.mark.parametrize("times,b", [([23], 1), ([23, 15, 7], 1), ([23, 15, 7], 3)])
def test_student_sampler_and_plain_chain_match_jax_chain_interpret(small, times, b):
    jm, params, tm = small
    key = jax.random.PRNGKey(5 + b)
    rng = np.random.RandomState(b)
    ctx = rng.randn(b, 5).astype(np.float32)
    jax_sched = jax_make_schedule("exponential", 25)
    want = np.asarray(jax_ddim_chain(jm, params, jax_sched, times, n_samples=b,
                                     interpret=True)(jnp.asarray(ctx), key))
    # the x_init the JAX chain draws from its key (fused_denoise.py:238)
    x_init = np.array(jax.random.normal(key, (b, H, 1), jnp.float32))
    want_xla = np.asarray(jax_dist.make_student_ddim_sampler(jax_sched, jm.apply, times)(
        params, jnp.asarray(ctx), key, (b, H, 1), x_init=jnp.asarray(x_init)))
    np.testing.assert_allclose(want_xla, want, rtol=TOL, atol=TOL)

    schedule = make_schedule("exponential", 25)
    got = make_student_ddim_sampler(schedule, tm, times)(torch.from_numpy(ctx),
                                                         torch.from_numpy(x_init))
    chain = make_fused_ddim_chain(tm, schedule, times, n_samples=b, device="cpu")
    got_chain = chain(torch.from_numpy(ctx), torch.from_numpy(x_init))
    assert (chain.launches, chain.plain_calls) == (0, 1)
    assert chain.noise_shape == (b, H, 1) and chain.n_total == len(times)
    for g in (got, got_chain):
        assert g.shape == (b, H, 1) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(got_chain, got, rtol=0, atol=0)


def test_student_sampler_broadcasts_one_shared_draw(small):
    """As the JAX sampler's x_init: one (1, H, D) draw shared by a batch."""
    _, _, tm = small
    sample = make_student_ddim_sampler(make_schedule("exponential", 25), tm, [23, 15, 7])
    ctx = torch.from_numpy(np.random.RandomState(0).randn(3, 5).astype(np.float32))
    x1 = torch.from_numpy(np.random.RandomState(1).randn(1, H, 1).astype(np.float32))
    torch.testing.assert_close(sample(ctx, x1), sample(ctx, x1.expand(3, H, 1).clone()),
                               rtol=0, atol=0)


def test_collect_cost_matches_jax():
    got, want = cartpole_virtual_collect_cost(), jax_cp.cartpole_virtual_collect_cost()
    for name in ("q_diag", "r", "p_diag"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    rng = np.random.RandomState(3)
    x, u = rng.randn(7, 5).astype(np.float32), rng.randn(7, 1).astype(np.float32)
    np.testing.assert_allclose(got.stage(torch.from_numpy(x), torch.from_numpy(u)).numpy(),
                               np.asarray(jax.vmap(want.stage)(x, u)), rtol=1e-6)
    np.testing.assert_allclose(got.terminal(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.vmap(want.terminal)(x)), rtol=1e-6)


def test_load_student_matches_jax_forward():
    tm = load_student(STUDENT, device="cpu")
    assert tm.cfg_indicator and sum(p.numel() for p in tm.parameters()) == 1_001_825
    with open(STUDENT, "rb") as f:
        params = pickle.load(f)
    cfg = dict(FLAGSHIP_CONFIG)
    assert cfg["dim_mults"] == tuple(UNET_DIM_MULTS[0])
    jm = JaxUnet(conditioning_type="default", cfg_indicator=True, **cfg)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 32, 1).astype(np.float32)
    t = np.array([23, 7], np.int32)
    ctx = rng.randn(2, 5).astype(np.float32)
    mask = np.zeros((2, 1), np.float32)
    want = np.asarray(jm.apply(params, x, t, ctx, mask))
    got = tm(torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)), torch.from_numpy(ctx),
             torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_teacher_stats_are_float32_limits():
    """The 12 committed statistics are limits normalizers of the shapes the
    student takes, each literal a float32 value exactly, and the flagship
    start x0 normalizes into [-1, 1]."""
    ins, cond = teacher_stats()
    assert (ins.kind, cond.kind) == ("limits", "limits")
    assert ins.mins.shape == ins.maxs.shape == (1,) and cond.mins.shape == cond.maxs.shape == (5,)
    for name, vals in (("INPUTS_MINS", ts.INPUTS_MINS), ("INPUTS_MAXS", ts.INPUTS_MAXS),
                       ("CONDITION_MINS", ts.CONDITION_MINS), ("CONDITION_MAXS", ts.CONDITION_MAXS)):
        assert [float(np.float32(v)) for v in vals] == list(vals), name
    assert bool((ins.mins < ins.maxs).all()) and bool((cond.mins < cond.maxs).all())
    x0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)])
    assert bool((normalize(cond, x0).abs() <= 1.0).all())
