"""The modules the port's ``scripts/bench_throughput.py`` needs beyond the
episode kernels, against the JAX package on the CPU: ``PointUnet`` (with
``MLP`` and ``TemporalBlockMLP``) on numpy-seeded params carried across by
``point_unet_from_flax_params``, the pendulum and the double integrator with
their costs (``dynamics/simple_plants.py``), and one CFG DDPM chain through
the ``PointUnet`` on the draws JAX makes from its key; then the port's
script at toy size, every one of the JAX script's seven rows.

Tolerances: the network 1e-5 (fp32 sums in other orders through four dense
blocks; the params drawn at scale 0.1, so the outputs stay near unit size),
the plants and costs 1e-6 (a few fp32 operations), the chain 1e-4 (the JAX
suite's for chains: 30 steps whose first coefficients are ~1e3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.dynamics import simple_plants as jax_sp
from mpc_via_diffusion_model_tpu.models import PointUnet as JaxPointUnet
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.dynamics import (double_integrator, double_integrator_cost,
                                                        get_plant, pendulum, pendulum_cost)
from mpc_via_diffusion_model_tpu_torch.models import (PointUnet, init_like_flax,
                                                      point_unet_from_flax_params)
from torch_port_util import randomize

torch.set_num_threads(1)

TOL_NET, TOL_PLANT, TOL_CHAIN = 1e-5, 1e-6, 1e-4


def _point_unets(conditioning, context_dim=2, seed=3):
    cfg = dict(state_dim=8, dim=32, context_dim=context_dim, conditioning_type=conditioning)
    jm = JaxPointUnet(**cfg)
    params = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 8)),
                                      jnp.zeros((1,), jnp.int32), jnp.zeros((1, context_dim)),
                                      jnp.zeros((1, 1))), seed, scale=0.1)
    tm = PointUnet(**cfg)
    tm.load_state_dict(point_unet_from_flax_params(params, tm))
    return jm, params, tm.eval()


@pytest.mark.parametrize("conditioning", ["default", "concatenate", None])
def test_point_unet_matches_jax(conditioning):
    """The port's ``PointUnet`` against the JAX one on the same params, half the contexts
    dropped by the mask; every flax Dense is carried (the state dict is complete)."""
    jm, params, tm = _point_unets(conditioning)
    rs = np.random.RandomState(1)
    x = rs.standard_normal((6, 1, 8)).astype(np.float32)
    t = rs.randint(0, 25, 6).astype(np.int32)
    ctx = rs.uniform(-1, 1, (6, 2)).astype(np.float32)
    mask = (rs.uniform(size=(6, 1)) < 0.5).astype(np.float32)
    want = jm.apply(params, *(jnp.asarray(a) for a in (x, t, ctx, mask)))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (x, t.astype(np.int64), ctx, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_NET, atol=TOL_NET)


def test_point_unet_init_like_flax_draws_flax_scales():
    """``init_like_flax`` on a ``PointUnet``: every bias 0, every kernel lecun_normal truncated
    at two standard units (std sqrt(1 / fan_in)), seeded and repeatable."""
    a, b = (init_like_flax(PointUnet(8, 32, context_dim=2, conditioning_type="default"),
                           np.random.RandomState(2)) for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            fan_in = p.shape[1]
            assert p.abs().max() <= 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566103423978 + 1e-6
            if p.numel() >= 1024:
                assert abs(float(p.detach().std()) * np.sqrt(fan_in) - 1.0) < 0.1, name


@pytest.mark.parametrize("name", ["pendulum", "double_integrator"])
def test_simple_plants_and_costs_match_jax(name):
    """Steps (one state and a batch through ``vmap``) and the stage and terminal costs of the
    pendulum and the double integrator against the JAX package's, by registry name too."""
    rs = np.random.RandomState(5)
    x = rs.uniform(-3, 3, (64, 2)).astype(np.float32)
    u = rs.uniform(-5, 5, (64, 1)).astype(np.float32)
    for dt in (None, 0.05):
        kw = {} if dt is None else {"dt": dt}
        plant = {"pendulum": pendulum, "double_integrator": double_integrator}[name](**kw)
        jplant = getattr(jax_sp, name)(**kw)
        assert (plant.state_dim, plant.control_dim, plant.dt) == (jplant.state_dim,
                                                                   jplant.control_dim, jplant.dt)
        want = jax.vmap(jplant.step)(jnp.asarray(x), jnp.asarray(u))
        got = plant.step(torch.from_numpy(x), torch.from_numpy(u))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_PLANT, atol=TOL_PLANT)
        one = plant.step(torch.from_numpy(x[0]), torch.from_numpy(u[0]))
        np.testing.assert_allclose(one.numpy(), np.asarray(want[0]), rtol=TOL_PLANT,
                                   atol=TOL_PLANT)
    cost, jcost = (pendulum_cost(), jax_sp.pendulum_cost()) if name == "pendulum" else \
        (double_integrator_cost(), jax_sp.double_integrator_cost())
    np.testing.assert_allclose(cost.stage(torch.from_numpy(x), torch.from_numpy(u)).numpy(),
                               np.asarray(jax.vmap(jcost.stage)(jnp.asarray(x), jnp.asarray(u))),
                               rtol=TOL_PLANT, atol=TOL_PLANT)
    np.testing.assert_allclose(cost.terminal(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.vmap(jcost.terminal)(jnp.asarray(x))),
                               rtol=TOL_PLANT, atol=TOL_PLANT)
    assert get_plant(name)[0].name == name


def test_ddpm_cfg_sample_through_point_unet_matches_jax():
    """One CFG DDPM chain of shape (1, 1, 8) through the ``PointUnet`` (the pendulum row's
    replan: T = 25 + 5, w = 0.01) against the JAX package's, on the draws JAX makes from its
    key."""
    jm, params, tm = _point_unets("default", seed=7)
    ctx = np.random.RandomState(6).uniform(-1, 1, (1, 2)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = JaxDiffusion(schedule=jax_make_schedule("exponential", 25)).ddpm_cfg_sample(
        lambda x, t, c, m: jm.apply(params, x, t, c, m), (1, 1, 8), key, jnp.asarray(ctx),
        w=0.01, n_diffusion_steps_without_noise=5)
    noise = np.array(jax.random.normal(key, (31, 1, 1, 8), jnp.float32))
    got = GaussianDiffusion(make_schedule("exponential", 25)).ddpm_cfg_sample(
        tm, (1, 1, 8), torch.from_numpy(ctx), w=0.01, n_diffusion_steps_without_noise=5,
        noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_CHAIN, atol=TOL_CHAIN)


def test_bench_throughput_prints_every_row_on_cpu(monkeypatch, tmp_path, capsys):
    """The port's script at its cut on the CPU (the fleet at 4 episodes for time): the JAX
    script's seven rows by their metric names, each a positive rate, the students' rows on the
    committed weights with their cost ratios, the fleet's first episode the single episode's,
    the report written under ``--out`` and not under ``artifacts/``."""
    from mpc_via_diffusion_model_tpu_torch.scripts import bench_throughput as bench
    monkeypatch.setattr(bench, "N_FLEET", 4)
    out = bench.main(["--device", "cpu", "--smoke-cut", "--out", str(tmp_path / "bt.json")])
    names = ["ddim_closed_loop_hz", f"candidates{bench.SMOKE_CUT['candidates']}_closed_loop_hz",
             "pendulum_pointunet_closed_loop_hz", "distilled_3eval_fused_episode_hz",
             "serving_4loops_control_steps_per_sec", "production_cfg30_flagship_bf16_hz",
             "distilled_3eval_sustained_hz"]
    assert list(out["rows"]) == names
    printed = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(printed) == 7
    rows = out["rows"]
    assert all(r["value"] > 0 for r in rows.values())
    assert rows["distilled_3eval_fused_episode_hz"]["real_weights"] is True
    assert "cost_ratio_vs_expert" in rows["production_cfg30_flagship_bf16_hz"]
    assert rows["serving_4loops_control_steps_per_sec"]["first_episode_vs_single_max_abs_err"] == 0
    assert (tmp_path / "bt.json").exists()
    with pytest.raises(SystemExit, match="not artifacts/"):
        bench.main(["--device", "cpu", "--out", str(bench.ROOT / "artifacts" / "bt.json")])
