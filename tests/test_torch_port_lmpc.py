"""The LMPC parity workload's modules in the port against the JAX package, on
the CPU: the linear cart-pole (``cartpole_lmpc``, its zero-order hold and
cost), the alternative stabilized cart-pole, the plant registry, the LQR
solver, the LQR expert's dataset collection, the statistics the committed
LMPC weights were trained on (``data/lmpc_stats.py``, regenerated here from
the recipe of their commit) and ``load_lmpc``'s forward on those weights.

Inputs are made with numpy from a seed. Tolerances: the plants rtol 1e-6
(atol 1e-6 for components that cancel toward 0; fp32 sums in other orders
than XLA's dot), the LQR solver 1e-5 (a Riccati recursion of 8 steps in
fp32, ``torch.linalg.solve`` against ``jnp.linalg.solve``), the forward 1e-5.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.data.datasets import ControlSequenceDataset as JaxDataset
from mpc_via_diffusion_model_tpu.data.generation import collect_lmpc_dataset as jax_collect
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu.dynamics import PLANTS as JAX_PLANTS
from mpc_via_diffusion_model_tpu.dynamics import get_plant as jax_get_plant
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu.solvers import lqr as jax_lqr
from mpc_via_diffusion_model_tpu_torch.data import (ControlSequenceDataset, collect_lmpc_dataset,
                                                    fit_normalizer, lmpc_stats)
from mpc_via_diffusion_model_tpu_torch.dynamics import PLANTS, cartpole, get_plant
from mpc_via_diffusion_model_tpu_torch.models import LMPC_CONFIG, load_lmpc
from mpc_via_diffusion_model_tpu_torch.scripts.lmpc_parity import linear_matrices
from mpc_via_diffusion_model_tpu_torch.solvers import (lqr_gains, lqr_solve, lqr_solve_batched)

torch.set_num_threads(1)

LMPC = Path(__file__).resolve().parents[1] / "artifacts" / "flagship_lmpc" / "ema_params.pkl"
H = 8
GRID = np.array([[p, 0.0, t, 0.0] for p in np.linspace(-1, 1, 15)
                 for t in np.linspace(-np.pi / 4, np.pi / 4, 15)], np.float32)


def _matrices():
    """(A, B, Q, R, P) of the linear cart-pole and its cost, as torch and as jax arrays."""
    mats = linear_matrices(cartpole.cartpole_lmpc(), cartpole.cartpole_lmpc_cost())
    return mats, tuple(jnp.asarray(m.numpy()) for m in mats)


def test_zoh_discretization_equals_jax_exactly():
    for dt in (0.1, 0.05):
        got = cartpole._zoh_discretize(cartpole._LMPC_A, cartpole._LMPC_B, dt)
        want = jax_cp._zoh_discretize(jax_cp._LMPC_A, jax_cp._LMPC_B, dt)
        for g, w in zip(got, want):
            assert g.dtype == np.float64
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(set(PLANTS) - {"panda"}))
def test_plant_and_cost_match_jax(name):
    """The step of every ported plant and its registry cost's stage and
    terminal on 64 seeded states and controls. The rigid-body arm
    (``panda``), whose float32 mass-matrix solve carries the libraries'
    last-bit differences of M and the bias into the step by M's condition,
    is held to JAX's in tests/test_torch_port_panda.py."""
    plant, cost = get_plant(name)
    jplant, jcost = jax_get_plant(name)
    assert (plant.state_dim, plant.control_dim, plant.dt) == (jplant.state_dim, jplant.control_dim,
                                                             jplant.dt)
    rng = np.random.RandomState(5)
    x = rng.randn(64, plant.state_dim).astype(np.float32)
    u = (rng.randn(64, plant.control_dim) * 3).astype(np.float32)
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    np.testing.assert_allclose(plant.step(tx, tu).numpy(),
                               np.asarray(jax.vmap(jplant.step)(jnp.asarray(x), jnp.asarray(u))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(cost.stage(tx, tu).numpy(),
                               np.asarray(jax.vmap(jcost.stage)(jnp.asarray(x), jnp.asarray(u))),
                               rtol=1e-6)
    np.testing.assert_allclose(cost.terminal(tx).numpy(),
                               np.asarray(jax.vmap(jcost.terminal)(jnp.asarray(x))), rtol=1e-6)


def test_lmpc_matrices_are_the_zoh_in_float32():
    """A and B read off the step are the float32 zero-order hold, and the
    kernel's constants are those numbers, A row-major then B."""
    (a, b, q, r, p), _ = _matrices()
    a_d, b_d = cartpole._zoh_discretize(cartpole._LMPC_A, cartpole._LMPC_B, 0.1)
    np.testing.assert_array_equal(a.numpy(), a_d.astype(np.float32))
    np.testing.assert_array_equal(b.numpy(), b_d.astype(np.float32))
    consts = np.float32(cartpole.cartpole_lmpc().device_consts)
    np.testing.assert_array_equal(consts, np.concatenate([a_d.reshape(-1), b_d.reshape(-1)])
                                  .astype(np.float32))
    assert torch.equal(torch.diag(q), torch.tensor([10.0, 1.0, 10.0, 1.0]))
    assert float(r) == 1.0 and torch.equal(torch.diag(p), torch.tensor([100.0, 1.0, 100.0, 1.0]))


@pytest.mark.parametrize("name,error", [
    ("cartpole_lmpc", None), ("cartpole_virtual_swingup", None),
    ("cartpole_virtual_stabilized", None), ("pendulum", NotImplementedError),
    ("double_integrator", NotImplementedError), ("acrobot", NotImplementedError),
    ("quadrotor", None), ("panda_surrogate", None), ("panda", None),
    ("no_such_plant", ValueError)])
def test_get_plant(name, error):
    """Every ported plant by its name (the plant named as JAX's: ``panda``
    is the rigid-body ``panda_rbd``), each other plant of the JAX registry
    refused as not ported, an unknown name refused as in JAX."""
    assert (name in JAX_PLANTS) == (error is not ValueError)
    if error is None:
        plant, cost = get_plant(name)
        assert plant.name == jax_get_plant(name)[0].name == {"panda": "panda_rbd"}.get(name, name)
        assert cost.q_diag.shape == (plant.state_dim,)
        assert get_plant(name, dt=0.02)[0].dt == 0.02
        return
    with pytest.raises(error, match="ROADMAP.md A5" if error is NotImplementedError else "unknown"):
        get_plant(name)


def test_lqr_gains_and_solve_match_jax():
    (a, b, q, r, p), (ja, jb, jq, jr, jp) = _matrices()
    ks = lqr_gains(a, b, q, r, p, H)
    jks = jax_lqr.lqr_gains(ja, jb, jq, jr, jp, H)
    np.testing.assert_allclose(ks.numpy(), np.asarray(jks), rtol=1e-5, atol=1e-5)
    x0 = np.random.RandomState(2).randn(16, 4).astype(np.float32)
    for gains in (None, ks):
        for i in range(4):
            got = lqr_solve(a, b, q, r, p, torch.from_numpy(x0[i]), H, gains=gains)
            want = jax_lqr.lqr_solve(ja, jb, jq, jr, jp, jnp.asarray(x0[i]), H,
                                     gains=None if gains is None else jks)
            for name in ("us", "xs", "cost"):
                np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                           rtol=1e-5, atol=1e-5, err_msg=name)
    got = lqr_solve_batched(a, b, q, r, p, torch.from_numpy(x0), H)
    want = jax_lqr.lqr_solve_batched(ja, jb, jq, jr, jp, jnp.asarray(x0), H)
    assert got.us.shape == (16, H, 1) and got.xs.shape == (16, H + 1, 4) and got.cost.shape == (16,)
    for name in ("us", "xs", "cost"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_collect_lmpc_dataset_matches_jax():
    """The grid pass with JAX's noise handed over: the same samples and the
    same limits."""
    (a, b, q, r, p), (ja, jb, jq, jr, jp) = _matrices()
    key, n_noisy = jax.random.PRNGKey(3), 5
    want = jax_collect(ja, jb, jq, jr, jp, GRID, horizon=H, noise_std=0.15, n_noisy=n_noisy, key=key)
    noise = np.asarray(jax.random.normal(key, (n_noisy,) + GRID.shape))
    got = collect_lmpc_dataset(a, b, q, r, p, GRID, H, noise_std=0.15, n_noisy=n_noisy,
                               noise=torch.from_numpy(noise))
    assert got.inputs.shape == (225 * 6, H, 1) and got.condition.shape == (225 * 6, 4)
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(want.inputs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.condition.numpy(), np.asarray(want.condition), rtol=1e-5,
                               atol=1e-5)
    assert isinstance(got, ControlSequenceDataset)  # the JAX function's type
    for field in ("inputs", "condition"):
        stats, jstats = got.normalizer.stats[field], want.normalizer.stats[field]
        np.testing.assert_allclose(stats.mins.numpy(), np.asarray(jstats.mins), rtol=1e-5)
        np.testing.assert_allclose(stats.maxs.numpy(), np.asarray(jstats.maxs), rtol=1e-5)
    plain = collect_lmpc_dataset(a, b, q, r, p, GRID[:4], H)  # no replicas
    assert plain.inputs.shape == (4, H, 1)
    drawn = collect_lmpc_dataset(a, b, q, r, p, GRID[:4], H, 0.15, 2,
                                 generator=torch.Generator().manual_seed(0))
    assert drawn.condition.shape == (12, 4) and torch.equal(drawn.condition[:4], plain.condition)


def _artifact_recipe_arrays(grid_pass, tracks, solve):
    """The arrays of the artifact commit's recipe (data/lmpc_stats.py):
    ``grid_pass()`` -> (inputs, condition) of the grid and its 399
    replicas; ``tracks()`` -> the expert's 50-step closed-loop states and
    horizons from every grid state, (225, 50, 4) and (225, 50, H, 1); 4
    replicas of those states from ``RandomState(1)``, solved by ``solve``."""
    u_grid, x_grid = grid_pass()
    xs, us = tracks()
    x_cl, u_cl = xs.reshape(-1, 4), us.reshape(-1, H, 1)
    noise = np.random.RandomState(1).normal(0, 0.15, (4,) + x_cl.shape)
    x_noisy = (x_cl[None] + noise).reshape(-1, 4).astype(np.float32)
    return (np.concatenate([u_grid, u_cl, solve(x_noisy)]),
            np.concatenate([x_grid, x_cl, x_noisy]))


def test_lmpc_stats_regenerate_from_the_artifact_recipe():
    """The JAX package's collection by the recipe of the weights' commit
    (its code as scripts/flagship_lmpc.py had it there) gives
    data/lmpc_stats.py's literals exactly (146,250 samples); the port's own
    collection, LQR solver and plant, with the grid pass's JAX noise handed
    over and the same RandomState(1) replicas, give the same limits to fp32
    rounding."""
    (a, b, q, r, p), (ja, jb, jq, jr, jp) = _matrices()
    key = jax.random.PRNGKey(0)
    jplant = jax_cp.cartpole_lmpc()

    def jax_grid():
        ds = jax_collect(ja, jb, jq, jr, jp, GRID, horizon=H, noise_std=0.15, n_noisy=399, key=key)
        return np.asarray(ds.inputs), np.asarray(ds.condition)

    def jax_tracks():
        def expert_track(x0):
            def body(xx, _):
                sol = jax_lqr.lqr_solve(ja, jb, jq, jr, jp, xx, H)
                return jplant.step(xx, sol.us[0]), (xx, sol.us)

            _, (xs, us) = jax.lax.scan(body, x0, None, length=50)
            return xs, us

        return tuple(np.asarray(v) for v in jax.jit(jax.vmap(expert_track))(jnp.asarray(GRID)))

    solve = jax.jit(jax.vmap(lambda xx: jax_lqr.lqr_solve(ja, jb, jq, jr, jp, xx, H).us))
    u_all, x_all = _artifact_recipe_arrays(jax_grid, jax_tracks,
                                           lambda x: np.asarray(solve(jnp.asarray(x))))
    assert u_all.shape == (146250, H, 1)
    ds = JaxDataset.from_arrays(u_all, x_all)
    ins, cond = lmpc_stats()
    for field, want in (("inputs", ins), ("condition", cond)):
        got = ds.normalizer.stats[field]
        np.testing.assert_array_equal(np.asarray(got.mins), want.mins.numpy())
        np.testing.assert_array_equal(np.asarray(got.maxs), want.maxs.numpy())

    plant = cartpole.cartpole_lmpc()
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, (399,) + GRID.shape)))

    def port_grid():
        ds = collect_lmpc_dataset(a, b, q, r, p, GRID, H, noise_std=0.15, n_noisy=399, noise=noise)
        return ds.inputs.numpy(), ds.condition.numpy()

    def port_tracks():
        x, xs, us = torch.from_numpy(GRID), [], []
        for _ in range(50):
            u_seq = lqr_solve(a, b, q, r, p, x, H).us
            xs.append(x)
            us.append(u_seq)
            x = plant.step(x, u_seq[:, 0])
        return torch.stack(xs, dim=1).numpy(), torch.stack(us, dim=1).numpy()

    u_port, x_port = _artifact_recipe_arrays(
        port_grid, port_tracks, lambda x: lqr_solve(a, b, q, r, p, torch.from_numpy(x), H).us.numpy())
    for got, want in ((fit_normalizer(u_port), ins), (fit_normalizer(x_port), cond)):
        np.testing.assert_allclose(got.mins.numpy(), want.mins.numpy(), rtol=1e-6)
        np.testing.assert_allclose(got.maxs.numpy(), want.maxs.numpy(), rtol=1e-6)


def test_load_lmpc_forward_matches_jax_apply():
    """The committed LMPC weights carried across: 1,000,929 parameters and
    the forward against the JAX model's ``apply`` at 3 seeded inputs, with
    and without the context."""
    import pickle

    tm = load_lmpc(LMPC, device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == 1_000_929
    assert (tm.n_support_points, tm.context_dim, tm.cfg_indicator) == (8, 4, True)
    with open(LMPC, "rb") as f:
        params = pickle.load(f)["ema_params"]
    jm = JaxUnet(state_dim=1, n_support_points=H, unet_input_dim=32, dim_mults=(1, 2, 4),
                 context_dim=4, conditioning_type="default", cfg_indicator=True)
    assert LMPC_CONFIG == dict(state_dim=1, n_support_points=H, unet_input_dim=32,
                               dim_mults=(1, 2, 4), time_emb_dim=32, context_dim=4)
    rng = np.random.RandomState(11)
    for i in range(3):
        x = rng.randn(2, H, 1).astype(np.float32)
        t = np.array([24, 3 * i], np.int32)
        ctx = rng.randn(2, 4).astype(np.float32)
        mask = np.array([[0.0], [1.0]], np.float32)
        want = jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(mask))
        with torch.no_grad():
            got = tm(torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)),
                     torch.from_numpy(ctx), torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
