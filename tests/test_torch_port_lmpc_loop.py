"""The slice as a whole at full width on the CPU: the LMPC parity workload's
closed loop in the port (``make_closed_loop`` with ``load_lmpc`` on the
committed weights, ``lmpc_stats()``, ``cartpole_lmpc``, one sample per
replan) against the JAX package's loop of ``scripts/flagship_lmpc.py``'s
step 3 on the same weights and statistics, from the sweep's first state.

The JAX loop's draws (keys ``split(fold_in(PRNGKey(7), 0), n_steps)``) are
handed over as numpy: the x and u tracks agree within 1e-4 (fp32 sums in
other orders through the U-Net and the plant; the closed loop is stable).
With its own ``torch.Generator`` noise the port's loop gives the state's
u_l1 against the LQR expert within 1e-3 + 1% of the JAX package's value
(``data/lmpc_stats.py``'s ``LMPC_U_L1``): the loop hardly depends on its
noise (two JAX keys' u tracks from this state differ by at most 8.3e-6).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pickle
import pytest
import torch

from mpc_via_diffusion_model_tpu.control import make_closed_loop as jax_closed_loop
from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu_torch.control import (ClosedLoopResult, make_closed_loop,
                                                       track_parity)
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import lmpc_stats
from mpc_via_diffusion_model_tpu_torch.data.lmpc_stats import LMPC_U_L1
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.dynamics import cartpole_lmpc, cartpole_lmpc_cost
from mpc_via_diffusion_model_tpu_torch.models import load_lmpc
from mpc_via_diffusion_model_tpu_torch.scripts import lmpc_parity

torch.set_num_threads(1)

LMPC = Path(__file__).resolve().parents[1] / "artifacts" / "flagship_lmpc" / "ema_params.pkl"
H, T, N_TAIL, W, N_STEPS = 8, 25, 5, 0.01, 50


@pytest.fixture(scope="module")
def setup():
    x0 = lmpc_parity.sweep_states(1)[0]
    loop = make_closed_loop(GaussianDiffusion(make_schedule("exponential", T)),
                            load_lmpc(LMPC, device="cpu"), *lmpc_stats(), cartpole_lmpc(),
                            cartpole_lmpc_cost(), horizon=H, n_steps=N_STEPS, w=W,
                            n_diffusion_steps_without_noise=N_TAIL, device="cpu")
    expert = lmpc_parity.expert_loop(cartpole_lmpc(), cartpole_lmpc_cost(), x0[None], N_STEPS)
    return x0, loop, ClosedLoopResult(expert.x_track[0], expert.u_track[0], None, None)


def test_lmpc_closed_loop_matches_jax_loop(setup):
    x0, loop, _ = setup
    with open(LMPC, "rb") as f:
        params = pickle.load(f)["ema_params"]
    jm = JaxUnet(state_dim=1, n_support_points=H, unet_input_dim=32, dim_mults=(1, 2, 4),
                 context_dim=4, conditioning_type="default", cfg_indicator=True)
    ins, cond = (JaxStats("limits", jnp.asarray(s.mins.numpy()), jnp.asarray(s.maxs.numpy()))
                 for s in lmpc_stats())
    jax_loop = jax_closed_loop(JaxDiffusion(schedule=jax_make_schedule("exponential", T)), jm.apply,
                               ins, cond, jax_cp.cartpole_lmpc(), jax_cp.cartpole_lmpc_cost(),
                               horizon=H, n_steps=N_STEPS, w=W,
                               n_diffusion_steps_without_noise=N_TAIL)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    want = jax.jit(jax_loop)(params, jnp.asarray(x0.numpy()), key)
    noise = np.stack([np.asarray(jax.random.normal(kk, (T + N_TAIL + 1, 1, H, 1), jnp.float32))
                      for kk in jax.random.split(key, N_STEPS)])
    got = loop(x0, torch.from_numpy(noise))
    for name in ("x_track", "u_track"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_lmpc_closed_loop_parity_with_its_own_noise(setup):
    x0, loop, expert = setup
    res = loop(x0, generator=torch.Generator().manual_seed(7))
    u_l1 = track_parity(res, expert)["u_l1"]
    assert abs(u_l1 - LMPC_U_L1[0]) <= 1e-3 + 0.01 * LMPC_U_L1[0], (u_l1, LMPC_U_L1[0])


@pytest.mark.parametrize("route", ["episode", "chain"])
def test_lmpc_parity_script_cut(route, capsys):
    """``scripts/lmpc_parity.py`` on the CPU at a cut size (2 states, 3
    replans, K = 1 and 8): its line has report.json's keys, the JAX
    package's and the report's numbers beside them, and no kernel launch."""
    out = lmpc_parity.main(["--device", "cpu", "--route", route, "--states", "2", "--steps", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in lmpc_parity.KEYS:
        assert np.isfinite(line[key]) and np.isfinite(line["candidates8"][key])
        assert key in line["report"] and key in line["report"]["candidates8"]
    assert set(line["jax_cpu"]) >= {"u_l1_mean", "u_l1_median", "u_l1_best", "u_l1_worst"}
    assert line["launches"] == {"1": 0, "8": 0} and len(line["per_state_u_l1"]["1"]) == 2
    x_track, u_track, chosen = out["tracks"][8][1]
    assert x_track.shape == (4, 4) and u_track.shape == (3, 1) and torch.isfinite(x_track).all()
    assert (chosen is None) == (route == "chain")
    if route == "episode":
        assert chosen.shape == (3,) and ((chosen >= 0) & (chosen < 8)).all()
