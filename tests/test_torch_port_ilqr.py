"""The port's iLQR (``solvers/ilqr.py``) and its NMPC loop
(``control/runtime.py::make_nmpc_closed_loop``) against the JAX package on
the CPU, and the yardstick of ``data/flagship_expert_yardstick.py``.

Inputs are made with numpy from a seed. Tolerances: ``pd_solve`` 1e-6; one
backward and one forward pass from the same states and controls 1e-4 (fp32
matmuls and Jacobians in other orders than XLA's); whole solves and the
NMPC prefix within the yardstick's bounds (``FIRST_STEP_BOUNDS``,
``EXPERT_BOUNDS``), which ``scripts/ilqr_divergence.py`` measured: the line
search's argmin and the accept test flip on an ulp, so a whole solve is only
as close to another as one ulp of its initial state allows.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.control import make_nmpc_closed_loop as jax_nmpc
from mpc_via_diffusion_model_tpu.data.generation import collect_closed_loop_dataset as jax_collect
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu.dynamics.base import Plant as JaxPlant
from mpc_via_diffusion_model_tpu.dynamics.base import QuadraticCost as JaxCost
from mpc_via_diffusion_model_tpu.solvers import ilqr as jax_ilqr
from mpc_via_diffusion_model_tpu_torch.control import make_nmpc_closed_loop
from mpc_via_diffusion_model_tpu_torch.data import flagship_expert_yardstick as ys
from mpc_via_diffusion_model_tpu_torch.dynamics import cartpole
from mpc_via_diffusion_model_tpu_torch.dynamics.base import Plant, QuadraticCost
from mpc_via_diffusion_model_tpu_torch.solvers import ilqr

torch.set_num_threads(1)

PLANT, COST = cartpole.cartpole_virtual_swingup(), cartpole.cartpole_virtual_cost()
JPLANT, JCOST = jax_cp.cartpole_virtual_swingup(), jax_cp.cartpole_virtual_cost()
CFG = ilqr.ILQRConfig(horizon=ys.HORIZON, n_iterations=ys.ITERATIONS)
JCFG = jax_ilqr.ILQRConfig(horizon=ys.HORIZON, n_iterations=ys.ITERATIONS)
# three states of the flagship grid (first, middle, last), each from both kicks
PICK = [0, 1, 398, 399, 210, 211]


def _rollout_inputs(seed: int, batch: int = 3):
    """(x0 (B, 5), us (B, H, 1), xs (B, H + 1, 5)): seeded states near the
    swing-up start, seeded controls and the JAX package's rollout."""
    rs = np.random.RandomState(seed)
    theta = rs.uniform(2.5, 3.8, batch).astype(np.float32)
    x0 = np.stack([rs.uniform(-1, 1, batch), rs.normal(0, 0.5, batch), theta,
                   rs.normal(0, 0.5, batch), jax_cp.theta_to_red_theta(theta)], 1).astype(np.float32)
    us = (rs.standard_normal((batch, ys.HORIZON, 1)) * 4).astype(np.float32)
    rollout = jax.jit(jax.vmap(lambda x, u: jax_ilqr._total_cost(JPLANT, JCOST, x, u)[1]))
    xs = np.array(rollout(jnp.asarray(x0), jnp.asarray(us)))
    return x0, us, xs


def test_pd_solve_matches_jax():
    """A PD matrix, an indefinite one with a positive diagonal (m = 2; the
    failure a diagonal-sign test misses) and a NaN input, batched."""
    rs = np.random.RandomState(0)
    a = rs.standard_normal((3, 3))
    mats = {"pd": (a @ a.T + 3 * np.eye(3)).astype(np.float32),
            "indefinite": np.array([[1.0, 2.0], [2.0, 1.0]], np.float32),
            "nan": np.array([[np.nan, 0.0], [0.0, 1.0]], np.float32)}
    for name, mat in mats.items():
        rhs = rs.standard_normal((len(mat), 4)).astype(np.float32)
        want, want_ok = jax_ilqr.pd_solve(jnp.asarray(mat), jnp.asarray(rhs))
        got, ok = ilqr.pd_solve(torch.from_numpy(mat), torch.from_numpy(rhs))
        assert bool(ok) == bool(want_ok) == (name == "pd"), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        if name != "pd":
            assert torch.equal(got, torch.zeros_like(got))
    batch = torch.from_numpy(np.stack([mats["indefinite"], mats["nan"], np.eye(2, dtype=np.float32)]))
    sol, ok = ilqr.pd_solve(batch, torch.ones(3, 2, 1))
    assert ok.tolist() == [False, False, True] and torch.equal(sol[2], torch.ones(2, 1))


def test_jacobians_are_float32_and_match_jax():
    """Reverse mode keeps float32 (forward mode through sin/cos returns
    float64 in this PyTorch); the values are jax.jacobian's."""
    x0, us, xs = _rollout_inputs(1)
    fx, fu = ilqr._jacobians(PLANT, torch.from_numpy(xs[:, :-1]), torch.from_numpy(us))
    assert fx.dtype == fu.dtype == torch.float32
    assert fx.shape == (3, ys.HORIZON, 5, 5) and fu.shape == (3, ys.HORIZON, 5, 1)
    jfx, jfu = jax.jit(jax.vmap(jax.vmap(jax.jacobian(JPLANT.step, argnums=(0, 1)))))(
        xs[:, :-1], us)
    np.testing.assert_allclose(fx.numpy(), np.asarray(jfx), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(fu.numpy(), np.asarray(jfu), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def one_pass():
    """One backward pass and the forward pass at every step size, from the
    same seeded states and controls, on both sides."""
    x0, us, xs = _rollout_inputs(2)
    reg = np.float32(1e-6)
    jb = jax.jit(jax.vmap(lambda x, u: jax_ilqr.ilqr_backward(JPLANT, JCOST, x, u, reg)))
    jks, jkg, jok = jb(jnp.asarray(xs), jnp.asarray(us))
    alphas = jnp.asarray(CFG.line_search_alphas, jnp.float32)
    jf = jax.jit(jax.vmap(jax.vmap(
        lambda a, x0_, xr, ur, k, kg: jax_ilqr.ilqr_forward(JPLANT, JCOST, x0_, xr, ur, k, kg, a),
        in_axes=(None, 0, 0, 0, 0, 0)), in_axes=(0, None, None, None, None, None)))
    jfw = jf(alphas, jnp.asarray(x0), jnp.asarray(xs), jnp.asarray(us), jks, jkg)
    t = torch.from_numpy
    ks, kg, ok = ilqr.ilqr_backward(PLANT, COST, t(xs), t(us), float(reg))
    # the forward pass from the JAX gains, so that it is held alone
    fw = ilqr.ilqr_forward(PLANT, COST, t(x0), t(xs), t(us), t(np.array(jks)),
                           t(np.array(jkg)), torch.tensor(CFG.line_search_alphas)[:, None])
    return (ks, kg, ok), (jks, jkg, jok), fw, jfw


def test_ilqr_backward_matches_jax_one_pass(one_pass):
    (ks, kg, ok), (jks, jkg, jok), _, _ = one_pass
    assert ok.tolist() == np.asarray(jok).tolist() == [True] * 3
    np.testing.assert_allclose(ks.numpy(), np.asarray(jks), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(kg.numpy(), np.asarray(jkg), rtol=1e-4, atol=1e-4)


def test_ilqr_forward_matches_jax_one_pass(one_pass):
    """Every step size as one batch axis (A, B)."""
    _, _, (us, xs, j), (jus, jxs, jj) = one_pass
    assert us.shape == (6, 3, ys.HORIZON, 1) and xs.shape == (6, 3, ys.HORIZON + 1, 5)
    for got, want in ((us, jus), (xs, jxs), (j, jj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_ilqr_solve_matches_jax_within_the_yardstick_bounds():
    """Three states of the flagship grid from both kicks, one batched solve
    of 25 iterations at H = 32, against the JAX package's vmapped solve."""
    x0, u_init = (v[PICK] for v in ys.first_step_batch())
    got = ilqr.ilqr_solve(PLANT, COST, x0, u_init, CFG)
    want = jax.jit(jax.vmap(lambda x, u: jax_ilqr.ilqr_solve(JPLANT, JCOST, x, u, JCFG)))(
        jnp.asarray(x0.numpy()), jnp.asarray(u_init.numpy()))
    gaps = ys.first_step_gaps(got, want=_torch_solution(want))
    assert ys.within(gaps, ys.FIRST_STEP_BOUNDS, ("cost_rel", "u0_max")), gaps
    assert gaps["backward_ok_differ"] == 0 and bool(got.backward_ok.all())
    assert got.us.shape == (6, ys.HORIZON, 1) and got.xs.shape == (6, ys.HORIZON + 1, 5)
    # the solution's states are its controls' rollout, and its cost theirs
    j, xs = ilqr._total_cost(PLANT, COST, x0, got.us)
    torch.testing.assert_close(xs, got.xs, rtol=0, atol=0)
    torch.testing.assert_close(j, got.cost, rtol=0, atol=0)


def _torch_solution(sol):
    return ilqr.ILQRSolution(*(torch.from_numpy(np.array(v)) for v in (
        sol.us, sol.xs, sol.cost, sol.improved_last_iter, sol.backward_ok)))


def test_ilqr_solve_batched_equals_one_by_one():
    """A batch with leading axes (3, 2) gives each solve's bits alone."""
    x0, u_init = (v[PICK] for v in ys.first_step_batch())
    cfg = ilqr.ILQRConfig(horizon=ys.HORIZON, n_iterations=4)
    batched = ilqr.ilqr_solve(PLANT, COST, x0.reshape(3, 2, 5), u_init.reshape(3, 2, -1, 1), cfg)
    assert batched.cost.shape == (3, 2) and batched.us.shape == (3, 2, ys.HORIZON, 1)
    flat = ilqr.ilqr_solve_batched(PLANT, COST, x0, u_init, cfg)
    for i in range(6):
        one = ilqr.ilqr_solve(PLANT, COST, x0[i], u_init[i], cfg)
        for name in ("us", "xs", "cost", "improved_last_iter", "backward_ok"):
            assert torch.equal(getattr(one, name), getattr(flat, name)[i]), name
            assert torch.equal(getattr(one, name), getattr(batched, name).flatten(0, 1)[i]), name


def test_ilqr_solve_never_takes_a_non_finite_candidate():
    """From x0 = 5 the full Newton step asks for |u| > 2, where the plant
    gives NaN: the step size 1 candidate's cost is NaN, set to +inf, and a
    smaller finite one is taken; the solution equals the JAX package's."""
    step = lambda x, u: x + 0.1 * u + torch.where(u.abs() > 2.0, torch.full_like(u, math.nan),
                                                  torch.zeros_like(u))
    jstep = lambda x, u: x + 0.1 * u + jnp.where(jnp.abs(u) > 2.0, jnp.nan, 0.0)
    plant = Plant("cliff", 1, 1, 0.1, step)
    cost = QuadraticCost(torch.tensor([1.0]), torch.tensor(0.01), torch.tensor([10.0]))
    jplant = JaxPlant("cliff", 1, 1, 0.1, jstep)
    jcost = JaxCost(jnp.asarray([1.0]), jnp.asarray(0.01), jnp.asarray([10.0]))
    h, x0, u0 = 8, torch.tensor([5.0]), torch.zeros(8, 1)
    j0, xs = ilqr._total_cost(plant, cost, x0, u0)
    ks, kg, ok = ilqr.ilqr_backward(plant, cost, xs, u0, 1e-6)
    _, _, j_cand = ilqr.ilqr_forward(plant, cost, x0, xs, u0, ks, kg,
                                     torch.tensor(CFG.line_search_alphas)[:, None])
    assert bool(ok) and math.isnan(j_cand[0].item()) and torch.isfinite(j_cand[1:]).any()
    cfg = ilqr.ILQRConfig(horizon=h, n_iterations=6)
    got = ilqr.ilqr_solve(plant, cost, x0, u0, cfg)
    want = jax.jit(lambda x, u: jax_ilqr.ilqr_solve(jplant, jcost, x, u,
                                                    jax_ilqr.ILQRConfig(horizon=h, n_iterations=6)))(
        jnp.asarray([5.0]), jnp.zeros((h, 1)))
    assert torch.isfinite(got.us).all() and got.cost.item() < j0.item()
    assert (got.us.abs() <= 2.0).all()
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.cost.item(), float(want.cost), rtol=1e-5)


def test_nmpc_prefix_matches_the_jax_expert():
    """``make_nmpc_closed_loop`` from the flagship's x0 (H = 32, 25
    iterations, kick 5): its first 5 steps within the yardstick's bounds of
    the JAX package's 80-step expert."""
    loop = make_nmpc_closed_loop(PLANT, COST, CFG, n_steps=5, u_init_scale=ys.KICKS[0],
                                 device="cpu")
    run = loop(torch.tensor(ys.EXPERT_X0))
    assert run.x_track.shape == (6, 5) and run.u_track.shape == (5, 1)
    assert run.u_horizons.shape == (5, ys.HORIZON, 1) and run.stage_costs.shape == (5,)
    gaps = ys.expert_gaps(run, 5)
    assert ys.within(gaps, ys.EXPERT_BOUNDS[5], ("cost_rel", "u_max", "x_max")), gaps
    torch.testing.assert_close(run.u_track, run.u_horizons[:, 0])


def test_nmpc_without_warm_start_and_batched():
    """Without ``warm_start`` every solve starts from the constant guess (the
    JAX package's loop, same inputs: 3 steps at H = 8, 5 iterations); a
    batch of x0 gives each run's bits alone."""
    cfg = ilqr.ILQRConfig(horizon=8, n_iterations=5)
    x0 = torch.tensor(ys.EXPERT_X0)
    cold = make_nmpc_closed_loop(PLANT, COST, cfg, n_steps=3, u_init_scale=-5.0,
                                 warm_start=False, device="cpu")(x0)
    x, us = x0, []
    for _ in range(3):
        sol = ilqr.ilqr_solve(PLANT, COST, x, torch.full((8, 1), -5.0), cfg)
        us.append(sol.us[0])
        x = PLANT.step(x, sol.us[0])
    assert torch.equal(cold.u_track, torch.stack(us)) and torch.equal(cold.x_track[-1], x)
    want = jax.jit(jax_nmpc(JPLANT, JCOST, jax_ilqr.ILQRConfig(horizon=8, n_iterations=5),
                            n_steps=3, u_init_scale=-5.0, warm_start=False))(jnp.asarray(x0.numpy()))
    np.testing.assert_allclose(cold.x_track.numpy(), np.asarray(want.x_track), rtol=1e-4, atol=1e-4)
    loop = make_nmpc_closed_loop(PLANT, COST, cfg, n_steps=2, u_init_scale=5.0, device="cpu")
    xb = torch.stack([x0, torch.tensor(ys.small_grid()[1])])
    batched = loop(xb)
    assert batched.x_track.shape == (2, 3, 5) and batched.u_horizons.shape == (2, 2, 8, 1)
    for i in range(2):
        one = loop(xb[i])
        for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
            assert torch.equal(getattr(one, name), getattr(batched, name)[i]), name


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_nmpc_closed_loop(PLANT, COST, CFG)


def jax_yardstick() -> dict:
    """Every literal of (a)-(c) in data/flagship_expert_yardstick.py, by the JAX package."""
    x0 = jnp.asarray(ys.EXPERT_X0)
    e = jax.jit(jax_nmpc(JPLANT, JCOST, JCFG, n_steps=ys.N_STEPS, u_init_scale=ys.KICKS[0]))(x0)
    x_b, u_b = (jnp.asarray(v.numpy()) for v in ys.first_step_batch())
    sol = jax.jit(jax.vmap(lambda x, u: jax_ilqr.ilqr_solve(JPLANT, JCOST, x, u, JCFG)))(x_b, u_b)
    ds = jax_collect(JPLANT, JCOST, ys.flagship_grid(), horizon=ys.HORIZON,
                     n_control_steps=ys.N_STEPS, solver_iterations=ys.ITERATIONS,
                     u_kick_scales=ys.KICKS, n_noisy=0, key=jax.random.PRNGKey(0))
    st = ds.normalizer.stats
    flat = lambda a: tuple(float(v) for v in np.asarray(a).reshape(-1))
    return {"EXPERT_X0": flat(x0), "EXPERT_U_TRACK": flat(e.u_track),
            "EXPERT_STAGE_COSTS": flat(e.stage_costs), "EXPERT_X_TRACK": flat(e.x_track),
            "EXPERT_COST": math.fsum(np.asarray(e.stage_costs, np.float64).tolist()),
            "FIRST_STEP_COSTS": flat(sol.cost), "FIRST_STEP_U0": flat(sol.us[:, 0, 0]),
            "FIRST_STEP_BACKWARD_OK": int(np.asarray(sol.backward_ok).sum()),
            "NOMINAL_N_SAMPLES": ds.n_init,
            "NOMINAL_CONVERGED_FRACTION": ds.solver_converged_fraction,
            **{f"NOMINAL_{f.upper()}_{k.upper()}": flat(getattr(st[f], k))
               for f in ("inputs", "condition") for k in ("mins", "maxs")}}


@pytest.mark.slow
def test_yardstick_regenerates():
    """The JAX package recomputes every literal of (a)-(c) exactly (~95 s)."""
    for name, value in jax_yardstick().items():
        assert value == getattr(ys, name), name


def test_ilqr_divergence_script_runs_on_cpu():
    """The measuring script's parts at toy depth: the expert over 2 steps
    (within the yardstick's bounds) and the small collection, each with one
    run moved by one ulp."""
    from mpc_via_diffusion_model_tpu_torch.scripts import ilqr_divergence as div
    expert = div.expert_runs("cpu", 2, div.PERTURBED[:1])
    assert expert["steps"] == 2 and len(expert["perturbed"]) == 1
    assert ys.within(expert["vs_yardstick"][2], ys.EXPERT_BOUNDS[5], ("cost_rel", "u_max", "x_max"))
    small = div.small_runs("cpu", div.PERTURBED[:1])
    assert small["rows"] == 96 and ys.within(small["perturbed"][0], ys.SMALL_BOUNDS,
                                             ("u_max", "x_max", "j_rel"))
    x = torch.tensor([[0.0, 0.0, 3.0, 0.0, 2.5]])
    moved = div.nudge(x, (2, 4), -1)
    assert torch.equal(moved[:, [0, 1, 3]], x[:, [0, 1, 3]])
    assert (moved[:, [2, 4]] < x[:, [2, 4]]).all() and torch.equal(div.nudge(moved, (2, 4), 1), x)


def test_ilqr_profile_script_runs_on_cpu():
    from mpc_via_diffusion_model_tpu_torch.scripts import ilqr_profile
    out = ilqr_profile.main(["--device", "cpu", "--batches", "2", "--iterations", "1",
                             "--profiled", "1"])
    (row,) = out["batches"]
    assert row["batch"] == 2 and row["ms_per_iteration"] > 0
    assert row["aten_calls_per_iteration"] >= row["top_level_aten_calls_per_iteration"] > 1000
    assert row["kernels_per_iteration"] == 0 and row["device_idle_share"] is None
