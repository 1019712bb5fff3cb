"""The port's flagship quality check: the normalizer fit (data/normalization.py),
``reference_mpc_cost`` (dynamics/base.py), the closed-loop metrics
(control/metrics.py) against the JAX package on numpy-seeded inputs, the
flagship dataset's 12 statistics (data/flagship_stats.py), and
``scripts/flagship_parity`` end to end at a cut size on the CPU.

Tolerances: the normalizer statistics are the same float32 numpy
computation, so equal; normalize and unnormalize 1e-6 (one fp32 affine map);
the MPC costs rtol 1e-5 (30 fp32 plant steps of two libraries, costs up to
1e7); the parity sums of |differences| 1e-5 (float32 sums of 81 terms).
"""
import json
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.control import metrics as jax_metrics
from mpc_via_diffusion_model_tpu.control.runtime import ClosedLoopResult as JaxResult
from mpc_via_diffusion_model_tpu.data import normalization as jax_norm
from mpc_via_diffusion_model_tpu.dynamics import base as jax_base
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu_torch.control import (ClosedLoopResult, count_swing_modes,
                                                       per_step_mpc_costs, track_parity)
from mpc_via_diffusion_model_tpu_torch.data import (NORMALIZERS, DatasetNormalizer,
                                                    canonical_kind, fit_normalizer)
from mpc_via_diffusion_model_tpu_torch.data.flagship_stats import flagship_stats
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_cost,
                                                        cartpole_virtual_swingup,
                                                        reference_mpc_cost)
from mpc_via_diffusion_model_tpu_torch.scripts import flagship_parity

ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts" / "flagship"

# Tiny tensors: torch's intra-op threads cost more than they save, and the
# suite runs several test processes at once.
torch.set_num_threads(1)


def _data(seed: int = 0):
    """(N, 3) samples with a constant column, which safe_limits pads for."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 10, 3) * [1.0, 30.0, 0.0] + [0.0, 5.0, 2.0]).astype(np.float32)
    return x


@pytest.mark.parametrize("kind", NORMALIZERS)
def test_fit_normalizer_matches_jax(kind):
    x = _data()
    want = jax_norm.fit_normalizer(x, kind, eps=0.5, fixed_min=-2.0, fixed_max=3.0)
    got = fit_normalizer(x, kind, eps=0.5, fixed_min=-2.0, fixed_max=3.0)
    assert got.kind == want.kind
    for field in ("mins", "maxs", "means", "stds"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    with pytest.raises(ValueError, match="unknown normalizer kind"):
        fit_normalizer(x, "minmax")


@pytest.mark.parametrize("name", ["LimitsNormalizer", "GaussianNormalizer", "Identity",
                                  "SafeLimitsNormalizer", "FixedLimitsNormalizer", "limits",
                                  "gaussian"])
def test_dataset_normalizer_matches_jax(name):
    assert canonical_kind(name) == jax_norm.canonical_kind(name)
    fields = {"inputs": _data(1)[..., :2], "condition": _data(2)}
    want = jax_norm.DatasetNormalizer.fit(fields, name)
    got = DatasetNormalizer.fit(fields, name)
    assert list(got.stats) == list(want.stats)
    for key, x in fields.items():
        y = np.random.RandomState(3).randn(*x.shape).astype(np.float32)
        np.testing.assert_allclose(got.normalize(torch.from_numpy(x), key).numpy(),
                                   np.asarray(want.normalize(jnp.asarray(x), key)), atol=1e-6)
        np.testing.assert_allclose(got.unnormalize(torch.from_numpy(y), key).numpy(),
                                   np.asarray(want.unnormalize(jnp.asarray(y), key)), rtol=1e-6,
                                   atol=1e-6)


def _tracks(seed: int, n_steps: int = 12, horizon: int = 32):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n_steps + 1, 5) * [0.5, 0.5, 1.0, 0.5, 1.0]).astype(np.float32)
    u_hor = (rng.randn(n_steps, horizon, 1) * 10).astype(np.float32)
    return x, u_hor[:, 0], u_hor, (rng.rand(n_steps) * 100).astype(np.float32)


@pytest.mark.parametrize("horizon", [2, 3, 32])
def test_reference_mpc_cost_matches_jax(horizon):
    """The quirks included: state 0 skipped in the stages, the final term on
    x_{H-2} rolled one step; batched rows equal the JAX function per row."""
    x, _, u_hor, _ = _tracks(4, horizon=horizon)
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_cost()
    want = np.array([float(jax_base.reference_mpc_cost(
        jax_cp.cartpole_virtual_swingup(), jax_cp.cartpole_virtual_cost(), jnp.asarray(x[i]),
        jnp.asarray(u_hor[i]))) for i in range(len(u_hor))])
    got = reference_mpc_cost(plant, cost, torch.from_numpy(x[:-1]), torch.from_numpy(u_hor))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    one = reference_mpc_cost(plant, cost, torch.from_numpy(x[0]), torch.from_numpy(u_hor[0]))
    np.testing.assert_allclose(one.item(), want[0], rtol=1e-5)


def test_metrics_match_jax():
    res, exp = _tracks(5), _tracks(6)
    jax_res, jax_exp = (JaxResult(*(jnp.asarray(a) for a in t)) for t in (res, exp))
    t_res, t_exp = (ClosedLoopResult(*(torch.from_numpy(a) for a in t)) for t in (res, exp))
    want = jax_metrics.per_step_mpc_costs(jax_cp.cartpole_virtual_swingup(),
                                          jax_cp.cartpole_virtual_cost(), jax_res)
    got = per_step_mpc_costs(cartpole_virtual_swingup(), cartpole_virtual_cost(), t_res)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    want_p, got_p = jax_metrics.track_parity(jax_res, jax_exp), track_parity(t_res, t_exp)
    assert list(got_p) == list(want_p)
    np.testing.assert_allclose(list(got_p.values()), list(want_p.values()), rtol=1e-5)
    # a shorter expert: the common length
    short = ClosedLoopResult(t_exp.x_track[:6], t_exp.u_track[:5], t_exp.u_horizons[:5],
                             t_exp.stage_costs[:5])
    want_s = jax_metrics.track_parity(jax_res, JaxResult(*(a[:n] for a, n in zip(
        (jax_exp.x_track, jax_exp.u_track, jax_exp.u_horizons, jax_exp.stage_costs),
        (6, 5, 5, 5)))))
    np.testing.assert_allclose(list(track_parity(t_res, short).values()), list(want_s.values()),
                               rtol=1e-5)
    thetas = np.random.RandomState(7).uniform(2.0, 4.5, (9, 13, 5)).astype(np.float32)
    for tracks in (thetas, thetas[..., 2]):
        assert count_swing_modes(torch.from_numpy(tracks)) == jax_metrics.count_swing_modes(tracks)


def test_metrics_reproduce_the_reports_parity_and_modality():
    """On the flagship run's stored tracks (seed 0's diffusion run and the
    expert's), the port's metrics give report.json's parity and modality."""
    report = json.loads((ARTIFACTS / "report.json").read_text())
    x_d, u_d = np.load(ARTIFACTS / "x_diffusion.npy"), np.load(ARTIFACTS / "u_diffusion.npy")
    expert = types.SimpleNamespace(x_track=np.load(ARTIFACTS / "x_mpc.npy"),
                                   u_track=np.load(ARTIFACTS / "u_mpc.npy"))
    parity = track_parity(types.SimpleNamespace(x_track=x_d[0], u_track=u_d[0]), expert)
    assert list(parity) == list(report["parity"])
    np.testing.assert_allclose(list(parity.values()), list(report["parity"].values()),
                               atol=1e-5)  # the report rounds to 5 decimals
    assert count_swing_modes(x_d) == report["modality"]


def test_flagship_statistics_shape_dtype_and_order():
    inputs, condition = flagship_stats()
    for stats, dim in ((inputs, 1), (condition, 5)):
        assert stats.kind == "limits"
        for t in (stats.mins, stats.maxs):
            assert t.shape == (dim,) and t.dtype == torch.float32 and t.device.type == "cpu"
        assert torch.all(stats.mins < stats.maxs)
    # the controls span the expert's, the states the expert's run from x0
    u_mpc, x_mpc = np.load(ARTIFACTS / "u_mpc.npy"), np.load(ARTIFACTS / "x_mpc.npy")
    assert inputs.mins.item() <= u_mpc.min() and u_mpc.max() <= inputs.maxs.item()
    assert np.all(condition.mins.numpy() <= x_mpc.min(axis=0))
    assert np.all(x_mpc.max(axis=0) <= condition.maxs.numpy())


def test_flagship_parity_script_runs_at_a_cut_size_on_cpu():
    out = flagship_parity.run_parity("cpu", n_seeds=2, n_steps=3)
    assert out["device"] == "cpu" and out["chain_launches"] == 0
    assert len(out["closed_loop_costs"]) == 2 and all(np.isfinite(out["closed_loop_costs"]))
    assert np.isfinite(out["horizon_cost_mean"]) and sum(out["modality"].values()) == 2
    assert set(out["parity"]) == set(out["parity_report"])
    assert out["closed_loop_cost_nmpc"] == 784750.6
    # the expert the cost is divided by: the JAX package's on the CPU (the yardstick's (a))
    assert out["expert_cost"] == 784750.029296875
    assert out["cost_over_expert"] == out["closed_loop_cost_mean"] / 784750.029296875
