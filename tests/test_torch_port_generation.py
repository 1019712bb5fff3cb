"""The port's closed-loop expert data (``data/generation.py``:
``make_initial_state_grid``, ``collect_closed_loop_dataset``) against the
JAX package on the CPU, at the size ``data/flagship_expert_yardstick.py``
calls ``SMALL``: grid 2 x 2, kicks +-5, 4 steps, 2 noisy replicas, H = 8, 5
iterations. The noisy replicas' normals are the JAX package's own draws
(its key splits, re-derived here) staged into the port.

Tolerance: every row within ``SMALL_BOUNDS``, which
``scripts/ilqr_divergence.py`` measured (the line search's argmin and the
accept test flip on an ulp; at H = 8 and 5 iterations the cost hardly sees
the late controls, so a flip moves them by tenths while the cost moves by
1e-7). The grids equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.data import generation as jax_gen
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu.dynamics.base import Plant as JaxPlant
from mpc_via_diffusion_model_tpu_torch.data import (ControlSequenceDataset,
                                                    collect_closed_loop_dataset,
                                                    make_initial_state_grid)
from mpc_via_diffusion_model_tpu_torch.data import flagship_expert_yardstick as ys
from mpc_via_diffusion_model_tpu_torch.dynamics import cartpole
from mpc_via_diffusion_model_tpu_torch.dynamics.base import Plant

torch.set_num_threads(1)

PLANT, COST = cartpole.cartpole_virtual_swingup(), cartpole.cartpole_virtual_cost()
JPLANT, JCOST = jax_cp.cartpole_virtual_swingup(), jax_cp.cartpole_virtual_cost()
KEYS = ("u_max", "x_max", "j_rel")


def jax_normals(key, n_grid: int, n_kick: int, n_steps: int, n_noisy: int, n: int = 5):
    """The standard normals the JAX collector draws from ``key``: (G, K, S, n_noisy, n)."""
    keys = jax.random.split(key, n_grid * n_kick).reshape(n_grid, n_kick, 2)
    draw = lambda k: jax.vmap(lambda ks: jax.random.normal(ks, (n_noisy, n)))(
        jax.random.split(k, n_steps))
    return torch.from_numpy(np.array(jax.vmap(jax.vmap(draw))(keys)))


def _both(plant, jplant, n_noisy=ys.SMALL["n_noisy"], **kw):
    """(port, JAX) ``return_arrays`` of the small collection on the same normals."""
    small = dict(ys.SMALL, n_noisy=n_noisy)
    grid, key = ys.small_grid(), jax.random.PRNGKey(3)
    want = jax_gen.collect_closed_loop_dataset(jplant, JCOST, grid, key=key, return_arrays=True,
                                               **small, **kw.get("jax", {}))
    normals = jax_normals(key, len(grid), 2, small["n_control_steps"], n_noisy) if n_noisy else None
    got = collect_closed_loop_dataset(plant, COST, grid, noise=normals, return_arrays=True,
                                      device="cpu", **small, **kw.get("port", {}))
    return got, want


def test_make_initial_state_grid_equals_jax_exactly():
    for args in (([-1.0, 1.0], np.linspace(3 * np.pi / 4, 5 * np.pi / 4, 20), 5,
                  (cartpole.theta_to_red_theta, jax_cp.theta_to_red_theta)),
                 (np.linspace(-1, 1, 3), np.linspace(-0.5, 0.5, 4), 4, (None, None))):
        pos, theta, dim, (tv, jtv) = args
        got = make_initial_state_grid(pos, theta, dim, tv)
        want = jax_gen.make_initial_state_grid(pos, theta, dim, jtv)
        assert got.dtype == np.float32 and got.shape == (len(pos) * len(theta), dim)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ys.flagship_grid()[:3], jax_gen.make_initial_state_grid(
        np.linspace(-1, 1, 10), np.linspace(3 * np.pi / 4, 5 * np.pi / 4, 20), 5,
        jax_cp.theta_to_red_theta)[:3])


def test_collect_closed_loop_dataset_matches_jax_at_a_small_size(capsys):
    """The same rows in the same order (nominal then noisy, group-major),
    within the bounds, and the same converged fraction; the dataset form
    carries it and fits its limits on these rows."""
    (u, x, j), (ju, jx, jj) = _both(PLANT, JPLANT)
    n_rows = 4 * 2 * 4 * (1 + 2)
    assert u.shape == (n_rows, 8, 1) and x.shape == (n_rows, 5) and j.shape == (n_rows,)
    gaps = ys.collection_gaps((u, x, j), (ju, jx, jj))
    assert ys.within(gaps, ys.SMALL_BOUNDS, KEYS), gaps
    # nominal rows first: step 0 of group (grid g, kick k) is grid state g
    grid = torch.from_numpy(ys.small_grid())
    torch.testing.assert_close(x[0:32:4], grid.repeat_interleave(2, dim=0), rtol=0, atol=0)
    out = capsys.readouterr().out.splitlines()
    fractions = [line for line in out if "converged fraction" in line]
    assert len(fractions) == 2 and fractions[0].split()[-1] == fractions[1].split()[-1]
    ds = collect_closed_loop_dataset(PLANT, COST, ys.small_grid(), device="cpu",
                                     generator=torch.Generator().manual_seed(0), **ys.SMALL)
    assert isinstance(ds, ControlSequenceDataset) and ds.solver_converged_fraction == 1.0
    assert len(ds) == n_rows and torch.equal(ds.condition[:32], x[:32])
    np.testing.assert_array_equal(ds.normalizer.stats["inputs"].maxs.numpy(),
                                  ds.inputs.amax(dim=(0, 1)).numpy())


def test_cold_start_and_state_to_condition_match_jax():
    """Every solve from the group's constant kick, and the conditions a map
    of the states (here the first four, doubled)."""
    kw = {"port": {"cold_start": True, "state_to_condition": lambda v: 2.0 * v[..., :4]},
          "jax": {"cold_start": True, "state_to_condition": lambda v: 2.0 * v[:4]}}
    (u, x, j), want = _both(PLANT, JPLANT, n_noisy=1, **kw)
    assert x.shape == (4 * 2 * 4 * 2, 4)
    gaps = ys.collection_gaps((u, x, j), want)
    assert ys.within(gaps, ys.SMALL_BOUNDS, KEYS), gaps


def test_blown_up_rows_are_dropped_as_jax_drops_them(capsys):
    """A plant that gives inf once the cart passes 0.5: the groups from the
    grid's position +1 have an infinite cost from the start, and their rows
    are dropped on both sides; the rest agree within the bounds."""
    step = lambda x, u: torch.where(x[..., :1] > 0.5, torch.full_like(x, float("inf")),
                                    PLANT.step(x, u))
    jstep = lambda x, u: jnp.where(x[:1] > 0.5, jnp.inf, JPLANT.step(x, u))
    plant = Plant("cliff_cartpole", 5, 1, 0.01, step)
    jplant = JaxPlant("cliff_cartpole", 5, 1, 0.01, jstep)
    got, want = _both(plant, jplant, n_noisy=1)
    assert len(got[0]) == len(want[0]) < 4 * 2 * 4 * 2
    assert all(torch.isfinite(v).all() for v in got)
    assert ys.within(ys.collection_gaps(got, want), ys.SMALL_BOUNDS, KEYS)
    assert "dropped" in capsys.readouterr().out


def test_collect_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collect_closed_loop_dataset(PLANT, COST, ys.small_grid(), **ys.SMALL)
    with pytest.raises(ValueError, match="noise must be"):
        collect_closed_loop_dataset(PLANT, COST, ys.small_grid(), noise=torch.zeros(3),
                                    device="cpu", **ys.SMALL)


# the JAX script's report keys (scripts/flagship_run.py), which the port's report keeps
JAX_REPORT_KEYS = {"n_samples", "collect_seconds", "solves_per_second", "train_steps",
                   "train_seconds", "final_loss", "parity", "closed_loop_cost_diffusion_mean10",
                   "closed_loop_cost_nmpc", "horizon_cost_diffusion_mean10", "horizon_cost_nmpc",
                   "modality"}


def test_flagship_run_script_end_to_end_at_a_cut_size(tmp_path):
    """Collect (grid 2 x 2, 2 steps, 1 replica), train 4 steps, evaluate 2
    seeds of 2 replans (the plain episode and chain here) and the expert;
    then the same evaluation again from the files with ``--reuse``; and
    ``--out artifacts/flagship`` refused."""
    from mpc_via_diffusion_model_tpu_torch.models import load_flagship
    from mpc_via_diffusion_model_tpu_torch.scripts import flagship_run
    args = ["--device", "cpu", "--out", str(tmp_path), "--grid-pos", "2", "--grid-theta", "2",
            "--steps", "2", "--noisy", "1", "--train-steps", "4", "--chunk", "2",
            "--batch-size", "8", "--seeds", "2", "--eval-steps", "2"]
    report = flagship_run.main(args)
    assert JAX_REPORT_KEYS <= set(report) and report["n_samples"] == 4 * 2 * 2 * 2
    assert report["train_steps"] == 4 and report["modality"]["left"] + report["modality"]["right"] == 2
    assert report["episode_launches"] == report["chain_launches"] == 0
    assert report["chain_route_max_abs_err"] <= 1e-3 and np.isfinite(report["cost_over_expert"])
    for name in ("dataset.npz", "ema_params.pkl", "report.json", "x_mpc.npy", "u_diffusion.npy",
                 "checkpoints/final.ckpt"):
        assert (tmp_path / name).exists(), name
    assert sum(p.numel() for p in load_flagship(tmp_path / "ema_params.pkl", "cpu").parameters()) \
        == 1_001_825
    again = flagship_run.main(args + ["--reuse"])
    assert again["collect_seconds"] is None and again["train_seconds"] is None
    assert again["closed_loop_costs_diffusion"] == report["closed_loop_costs_diffusion"]
    with pytest.raises(SystemExit):
        flagship_run.main(["--out", str(flagship_run.ROOT / "artifacts" / "flagship")])
