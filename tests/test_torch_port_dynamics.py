"""The port's plant helpers (dynamics/base.py: ``rollout``,
``rollout_with_cost``, batched steps and costs) against the JAX package,
and the cart-pole step as the episode kernel's device function writes it
(csrc/plants.cuh, emulated in tests/torch_port_util.py) against the port's
torch step."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_via_diffusion_model_tpu.dynamics import base as jax_base
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_cost,
                                                        cartpole_virtual_swingup, rollout,
                                                        rollout_with_cost)
from torch_port_util import cartpole_step_f32

TOL = 1e-5  # 32 Euler steps in fp32, sin/cos of two libraries


def _inputs(seed: int, batch=()):
    rng = np.random.RandomState(seed)
    x0 = (rng.randn(*batch, 5) * [0.5, 0.5, 1.0, 0.5, 1.0]).astype(np.float32)
    u = (rng.randn(*batch, 32, 1) * 10).astype(np.float32)
    return x0, u


def test_rollout_matches_jax():
    x0, u = _inputs(0)
    want = jax_base.rollout(jax_cp.cartpole_virtual_swingup(), jnp.asarray(x0), jnp.asarray(u))
    got = rollout(cartpole_virtual_swingup(), torch.from_numpy(x0), torch.from_numpy(u))
    assert got.shape == (33, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_rollout_with_cost_matches_jax():
    x0, u = _inputs(1)
    xs_w, c_w = jax_base.rollout_with_cost(jax_cp.cartpole_virtual_swingup(),
                                           jax_cp.cartpole_virtual_cost(), jnp.asarray(x0),
                                           jnp.asarray(u))
    xs, c = rollout_with_cost(cartpole_virtual_swingup(), cartpole_virtual_cost(),
                              torch.from_numpy(x0), torch.from_numpy(u))
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_w), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(c.item(), float(c_w), rtol=TOL)


def test_batched_rollout_and_costs_match_jax_vmap():
    """A leading batch axis stands in for the JAX package's vmap."""
    x0, u = _inputs(2, batch=(4,))
    plant, cost = jax_cp.cartpole_virtual_swingup(), jax_cp.cartpole_virtual_cost()
    xs_w, c_w = jax.vmap(lambda x, v: jax_base.rollout_with_cost(plant, cost, x, v))(
        jnp.asarray(x0), jnp.asarray(u))
    xs, c = rollout_with_cost(cartpole_virtual_swingup(), cartpole_virtual_cost(),
                              torch.from_numpy(x0), torch.from_numpy(u))
    assert xs.shape == (4, 33, 5) and c.shape == (4,)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_w), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_w), rtol=TOL)
    one = rollout(cartpole_virtual_swingup(), torch.from_numpy(x0[1]), torch.from_numpy(u[1]))
    torch.testing.assert_close(xs[1], one, rtol=0, atol=0)


def test_device_function_order_matches_torch_step():
    """The order of operations of plants.cuh's step, in float32 numpy, gives
    the torch step's result up to the last bits of sin and cos."""
    plant = cartpole_virtual_swingup()
    rng = np.random.RandomState(3)
    for _ in range(20):
        x = (rng.randn(5) * 2).astype(np.float32)
        u = (rng.randn(1) * 30).astype(np.float32)
        want = plant.step(torch.from_numpy(x), torch.from_numpy(u)).numpy()
        np.testing.assert_allclose(cartpole_step_f32(x, u, plant.dt), want, rtol=1e-6, atol=1e-6)
