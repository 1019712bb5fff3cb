"""The AMPC baseline in the PyTorch port against the JAX package, on the
CPU: ``AMPCNet``'s forward on carried weights, ``fit_mlp_regression`` on
JAX's own draws, ``make_ampc_closed_loop``, the yardstick's (c) and the
``train_ampc`` script at toy size.

Inputs are made with numpy from a seed; weights are carried across in the
flax layout (``mlp_to_flax_params``). Tolerances: the forward 1e-6; the fit
after 200 steps 1e-5 on the EMA weights (float32 Adam on a small MLP; the
measured gap is ~1e-7); closed loops 1e-4 in controls and states relative
to their scale.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.control.runtime import make_ampc_closed_loop as jax_ampc_loop
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu.models import AMPCNet as JaxAmpc
from mpc_via_diffusion_model_tpu.train.regression import fit_mlp_regression as jax_fit
from mpc_via_diffusion_model_tpu_torch.control import make_ampc_closed_loop
from mpc_via_diffusion_model_tpu_torch.data import distill_yardstick as dy
from mpc_via_diffusion_model_tpu_torch.data.teacher_stats import teacher_stats
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_collect_cost,
                                                        cartpole_virtual_swingup)
from mpc_via_diffusion_model_tpu_torch.models import (AMPCNet, init_mlp_like_flax, load_ampc,
                                                      mlp_from_flax_params, mlp_to_flax_params)
from mpc_via_diffusion_model_tpu_torch.scripts import train_ampc
from mpc_via_diffusion_model_tpu_torch.train import fit_mlp_regression

torch.set_num_threads(1)


def _port(params, horizon, hidden=(2, 50, 50)):
    m = AMPCNet(horizon, hidden=hidden)
    m.load_state_dict(mlp_from_flax_params(params, m))
    return m.eval()


def _jax_stats(stats):
    return JaxStats("limits", jnp.asarray(stats.mins.numpy()), jnp.asarray(stats.maxs.numpy()))


@pytest.mark.parametrize("hidden", [(2, 50, 50), (64, 64)], ids=["reference", "wide"])
def test_forward_on_carried_weights_matches_jax(hidden):
    """The reference's stack and a wider one: the same output (1e-6), the
    flax layout carried both ways exactly."""
    params = dy.ampc_params(horizon=16, hidden=hidden)
    m = _port(params, 16, hidden)
    back = mlp_to_flax_params(m)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, params))
    x = np.random.RandomState(0).uniform(-1, 1, (7, 5)).astype(np.float32)
    want = JaxAmpc(horizon=16, hidden=hidden).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.shape == (7, 16, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_init_mlp_like_flax_statistics():
    """flax's Dense init: biases 0, kernels within 2 sigma (sigma = sqrt(1 /
    fan_in) / 0.8796) with std sqrt(1 / fan_in) within 5% over 200 draws."""
    m = AMPCNet(64)
    ks = {n: [] for n, _ in m.named_parameters() if n.endswith("weight")}
    rs = np.random.RandomState(1)
    for _ in range(200):
        init_mlp_like_flax(m, rs)
        for n, p in m.named_parameters():
            if n.endswith("bias"):
                assert (p == 0).all()
            else:
                ks[n].append(p.detach().numpy().copy())
    for n, draws in ks.items():
        w = np.stack(draws)
        fan_in = w.shape[-1]
        assert np.abs(w).max() <= 2 * np.sqrt(1 / fan_in) / 0.87962566103423978 * (1 + 1e-6), n
        assert abs(w.std() / np.sqrt(1 / fan_in) - 1) < 0.05, n


def _jax_fit_draws(seed, steps, chunk, batch, n):
    """The indices JAX's fit_mlp_regression draws, step by step."""
    key, out = jax.random.PRNGKey(seed + 1), []
    for _ in range(steps // chunk):
        key, k = jax.random.split(key)
        for kk in jax.random.split(k, chunk):
            k_idx, _ = jax.random.split(kk)
            out.append(np.asarray(jax.random.randint(k_idx, (batch,), 0, n)))
    return torch.from_numpy(np.stack(out).astype(np.int64))


def test_fit_mlp_regression_matches_jax():
    """200 steps (chunks of 50, batch 32) from JAX's own init on the indices
    its keys draw: the EMA within 1e-5 of the largest weight, the last loss
    within 1e-5; with too few steps both refuse."""
    rs = np.random.RandomState(2)
    n, h, seed = 256, 8, 30
    conds = rs.uniform(-1, 1, (n, 5)).astype(np.float32)
    inputs = np.tanh(conds @ rs.standard_normal((5, h)))[..., None].astype(np.float32)
    jm = JaxAmpc(horizon=h)
    jema, jloss = jax_fit(jm, jnp.asarray(inputs), jnp.asarray(conds), steps=200, chunk=50,
                          batch_size=32, lr=1e-2, seed=seed)
    init = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, 5)))
    ema, loss = fit_mlp_regression(AMPCNet(h), torch.from_numpy(inputs), torch.from_numpy(conds),
                                   steps=200, chunk=50, batch_size=32, lr=1e-2,
                                   init_params=jax.tree_util.tree_map(np.asarray, init),
                                   draws=_jax_fit_draws(seed, 200, 50, 32, n))
    scale = max(float(np.abs(v).max()) for v in jax.tree_util.tree_leaves(jema))
    for got, want in zip(jax.tree_util.tree_leaves(ema), jax.tree_util.tree_leaves(jema)):
        np.testing.assert_allclose(got / scale, np.asarray(want) / scale, rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert jloss < 0.5 * float(np.mean(inputs ** 2))   # it learned
    for fit in (jax_fit, fit_mlp_regression):
        with pytest.raises(ValueError, match="zero chunks"):
            fit(jm if fit is jax_fit else AMPCNet(h), inputs, conds, steps=10, chunk=50,
                batch_size=8, lr=1e-2)


def test_ampc_closed_loop_matches_jax():
    """20 steps at H = 16 on random weights and the teacher's statistics:
    controls, states and stage costs within 1e-4 of their scale."""
    params = dy.ampc_params(horizon=16, seed=7)
    ins, cond = teacher_stats()
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_collect_cost()
    x0 = np.asarray(dy.X0, np.float32)
    want = jax.jit(jax_ampc_loop(JaxAmpc(horizon=16).apply, _jax_stats(ins), _jax_stats(cond),
                                 jax_cp.cartpole_virtual_swingup(),
                                 jax_cp.cartpole_virtual_collect_cost(), n_steps=20))(
        params, jnp.asarray(x0))
    got = make_ampc_closed_loop(_port(params, 16), ins, cond, plant, cost, n_steps=20,
                                device="cpu")(torch.from_numpy(x0))
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_port_follows_the_ampc_yardstick():
    """Yardstick (c) on the CPU: the port's 80-step AMPC loop at H = 64 on
    ampc_params() against the JAX package's literals: controls within 1e-4
    of their scale, the summed cost within 1e-5."""
    ins, cond = teacher_stats()
    run = make_ampc_closed_loop(_port(dy.ampc_params(), dy.HORIZON), ins, cond,
                                cartpole_virtual_swingup(), cartpole_virtual_collect_cost(),
                                n_steps=dy.N_EXPERT_STEPS, device="cpu")(torch.tensor(dy.X0))
    u = run.u_track[:, 0].double().numpy()
    want = np.asarray(dy.AMPC_U_TRACK)
    np.testing.assert_allclose(u, want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(run.stage_costs.double().sum().item(), dy.AMPC_COST, rtol=1e-5)


def test_train_ampc_script_at_toy_size(tmp_path):
    """train_ampc on a 64-sample dataset for 6 steps: ampc.ckpt has the JAX
    file's keys, load_ampc reads it, and the JAX AMPCNet applies its EMA to
    the port's output (1e-6)."""
    rs = np.random.RandomState(3)
    np.savez(tmp_path / "ds.npz", inputs=rs.standard_normal((64, 8, 1)).astype(np.float32),
             condition=rs.standard_normal((64, 5)).astype(np.float32))
    out = train_ampc.main(["--dataset", str(tmp_path / "ds.npz"), "--results-dir",
                           str(tmp_path / "ampc"), "--steps", "6", "--batch-size", "16",
                           "--device", "cpu"])
    assert np.isfinite(out["final_loss"])
    with open(tmp_path / "ampc" / "ampc.ckpt", "rb") as f:
        ck = pickle.load(f)
    assert set(ck) == {"params", "ema_params", "horizon", "control_dim"}
    assert (ck["horizon"], ck["control_dim"]) == (8, 1)
    m = load_ampc(tmp_path / "ampc" / "ampc.ckpt", device="cpu")
    x = rs.uniform(-1, 1, (3, 5)).astype(np.float32)
    want = JaxAmpc(horizon=8).apply(ck["ema_params"], jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
