"""The panda arm's student in the port against the JAX package on the CPU:
the arm (``dynamics/arm.py``: kinematics, context, recursive Newton-Euler,
mass matrix, the plants and the kernel's unrolled forms), the dataset's
statistics (``data/panda_stats.py``), the student's forward, the plans of
shared memory on one and two row-sets at horizon 128 (``ops/unet_pack.py``:
the U-Net pass and the DDIM chain on one row-set emulated with the cluster
race check against ``TemporalUnet``; the CFG builders' plan in turns and
their refusal past the limit), the numpy
twins of the kernel's ``PandaRbd`` and ``PandaContext``
(``tests/torch_port_util.py``) against the torch versions and through the
emulated episode program, the student's closed loop through the chain
split and the plain episode against the JAX package's loop on the same
staged noise, and the yardstick (``data/panda_yardstick.py``; it
regenerates under ``slow``).

Tolerances: rtol = atol = 1e-5 for the arm's functions (XLA and torch sum
the 3 x 3 and 4 x 4 products in other orders), 1e-4 for a plant step (the
float32 mass-matrix solve carries M's last-bit differences by its
condition) and for loops and episodes, the JAX suite's
(tests/test_fused_episode.py:59), with the controls in normalized units
(divided by the limits' half range, up to 32 N m: the student's output
scaled), as chip_smoke.py holds the kernels' controls; the twins bit for
bit, given torch's sin, cos and sqrt.
"""
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.control import make_closed_loop as jax_closed_loop
from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.data.datasets import ControlSequenceDataset
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.diffusion.distillation import (
    make_student_ddim_sampler as jax_student_sampler)
from mpc_via_diffusion_model_tpu.dynamics import arm as jarm
from mpc_via_diffusion_model_tpu.dynamics import get_plant as jax_get_plant
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu_torch.control import make_closed_loop
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import panda_stats as ps
from mpc_via_diffusion_model_tpu_torch.data import panda_yardstick as pys
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion, make_student_ddim_sampler
from mpc_via_diffusion_model_tpu_torch.dynamics import arm, get_plant
from mpc_via_diffusion_model_tpu_torch.models import (PANDA_STUDENT_CONFIG, TemporalUnet,
                                                      from_flax_params, load_panda_student)
from mpc_via_diffusion_model_tpu_torch.ops import unet_pack as up
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import (make_fused_cfg_chain,
                                                                 make_fused_ddim_chain)
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import (make_fused_cfg_episode,
                                                                 make_fused_ddim_episode)
from mpc_via_diffusion_model_tpu_torch.ops.fused_unet import make_fused_unet
from torch_port_util import (emulate_ddim_chain_kernel, emulate_ddim_episode_kernel,
                             emulate_fused_unet_kernel, panda_context_condition,
                             panda_context_f32, panda_plant_step, panda_rbd_step_f32, randomize)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DATASET = ROOT / "artifacts" / "flagship_panda_rbd" / "dataset.npz"
TOL, FN_TOL, STEP_TOL = 1e-4, 1e-5, 1e-4


def _states(n: int = 64, seed: int = 0):
    """Seeded shifted states around the ready pose (q - q_ref, qd), controls
    of the dataset's size (torques of a few N m), joint accelerations."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.randn(n, 7) * 0.4, rng.randn(n, 7)], 1).astype(np.float32)
    u = (rng.randn(n, 7) * 5).astype(np.float32)
    qdd = rng.randn(n, 7).astype(np.float32)
    q = (x[:, :7] + arm.PANDA_READY_POSE).astype(np.float32)
    return x, u, q, qdd


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat_transforms(out):
    """The list of 7 (R, p) as (..., 7, 12)."""
    return np.stack([np.concatenate([np.asarray(r).reshape(*np.shape(p)[:-1], 9), np.asarray(p)],
                                    -1) for r, p in out], -2)


def _arm_pair(name):
    """(port value, JAX value, tolerance) of one function of dynamics/arm.py
    on the seeded batch."""
    x, u, q, qdd = _states()
    qd = x[:, 7:]
    if name == "fk":
        return arm.panda_fk(_t(q)), jax.vmap(jarm.panda_fk)(q), FN_TOL
    if name == "ee_velocity":
        return arm.panda_ee_velocity(_t(q), _t(qd)), jax.vmap(jarm.panda_ee_velocity)(q, qd), FN_TOL
    if name == "context":
        return arm.panda_context(_t(np.concatenate([q, qd], 1))), jax.vmap(jarm.panda_context)(
            np.concatenate([q, qd], 1)), FN_TOL
    if name == "make_panda_context":
        return arm.make_panda_context()(_t(x)), jax.vmap(jarm.make_panda_context())(x), FN_TOL
    if name == "link_transforms":
        return (_flat_transforms(arm.panda_link_transforms(_t(q))),
                _flat_transforms(jax.vmap(jarm.panda_link_transforms)(q)), FN_TOL)
    if name == "inverse_dynamics":
        return (arm.panda_inverse_dynamics(_t(q), _t(qd), _t(qdd)),
                jax.vmap(jarm.panda_inverse_dynamics)(q, qd, qdd), FN_TOL)
    if name == "inverse_dynamics_unrolled":
        return (arm.panda_inverse_dynamics_unrolled(_t(q), _t(qd), _t(qdd)),
                jax.vmap(jarm.panda_inverse_dynamics_unrolled)(q, qd, qdd), FN_TOL)
    if name == "mass_matrix":
        return arm.panda_mass_matrix(_t(q)), jax.vmap(jarm.panda_mass_matrix)(q), FN_TOL
    if name == "solve_spd_unrolled":  # on JAX's M, so that only the solve's arithmetic differs
        m = np.asarray(jax.vmap(jarm.panda_mass_matrix)(q))
        return (arm.solve_spd_unrolled(_t(m), _t(u)),
                jax.vmap(jarm._solve_spd_unrolled)(m, u), FN_TOL)
    if name == "cost":
        cost, jcost = arm.panda_cost(), jarm.panda_cost()
        return (torch.stack([cost.stage(_t(x), _t(u)), cost.terminal(_t(x))], -1),
                jnp.stack([jax.vmap(jcost.stage)(x, u), jax.vmap(jcost.terminal)(x)], -1), FN_TOL)
    # the unrolled step against JAX's scan and solve, which the JAX package holds its unrolled
    # step to at fp32 round-off (tests/test_arm.py:192): XLA takes ~25 s to compile the unrolled
    # one, whose pieces are checked above
    plant, jplant = {"surrogate_step": (arm.panda_surrogate(), jarm.panda_surrogate()),
                     "rbd_step": (arm.panda_rbd(), jarm.panda_rbd()),
                     "rbd_unrolled_step": (arm.panda_rbd_unrolled(), jarm.panda_rbd())}[name]
    assert (plant.name, plant.state_dim, plant.control_dim, plant.dt) == (
        jplant.name, jplant.state_dim, jplant.control_dim, jplant.dt)
    return plant.step(_t(x), _t(u)), jax.jit(jax.vmap(jplant.step))(x, u), STEP_TOL


@pytest.mark.parametrize("name", ["fk", "ee_velocity", "context", "make_panda_context",
                                  "link_transforms", "inverse_dynamics",
                                  "inverse_dynamics_unrolled", "mass_matrix",
                                  "solve_spd_unrolled", "cost", "surrogate_step", "rbd_step",
                                  "rbd_unrolled_step"])
def test_arm_function_matches_jax(name):
    """Every function of dynamics/arm.py against the JAX package's on 64
    seeded states around the ready pose: rtol = atol = 1e-5, a plant's step
    1e-4 (the unrolled step against JAX's scan-and-solve step)."""
    got, want, tol = _arm_pair(name)
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_registry_and_kernel_constants():
    """``get_plant('panda')`` is the rigid-body arm with the kernel's table;
    the table and the context's constants are JAX's constants in float32."""
    plant, cost = get_plant("panda")
    assert plant.name == "panda_rbd" and get_plant("panda_surrogate")[0].name == "panda_surrogate"
    pc = np.float32(plant.device_consts)
    assert pc.size == 140 and np.array_equal(pc, np.float32(arm.panda_rbd_unrolled().device_consts))
    lk = pc[:35].reshape(7, 5)
    dh = jarm._PANDA_DH
    np.testing.assert_array_equal(lk[:, 0], dh[:, 0].astype(np.float32))
    np.testing.assert_array_equal(lk[:, 1], np.cos(dh[:, 2]).astype(np.float32))
    np.testing.assert_array_equal(lk[:, 3], (-dh[:, 1] * np.sin(dh[:, 2])).astype(np.float32))
    np.testing.assert_array_equal(pc[35:42], jarm._PANDA_MASS.astype(np.float32))
    np.testing.assert_array_equal(pc[42:63], jarm._PANDA_COM.reshape(-1).astype(np.float32))
    np.testing.assert_array_equal(pc[63:126], jarm._PANDA_INERTIA.reshape(-1).astype(np.float32))
    np.testing.assert_array_equal(pc[126:133], jarm._PANDA_VISCOUS.astype(np.float32))
    np.testing.assert_array_equal(pc[133:], jarm.PANDA_READY_POSE.astype(np.float32))
    ctx = arm.make_panda_context()
    assert ctx.kind == "panda_context" and len(ctx.device_consts) == 43
    np.testing.assert_array_equal(np.float32(ctx.device_consts[7:42]), lk.reshape(-1))
    assert np.float32(ctx.device_consts[42]) == np.float32(jarm._FLANGE_D)


def test_panda_stats_equal_the_datasets():
    """The 54 committed limits are the JAX package's normalizer statistics
    of ``artifacts/flagship_panda_rbd/dataset.npz``, exactly."""
    stats = ControlSequenceDataset.load(str(DATASET)).normalizer.stats
    ins, cond = ps.panda_stats()
    for port, key in ((ins, "inputs"), (cond, "condition")):
        want = stats[key]
        assert port.kind == want.kind == "limits"
        np.testing.assert_array_equal(port.mins.numpy(), np.asarray(want.mins, np.float32).reshape(-1))
        np.testing.assert_array_equal(port.maxs.numpy(), np.asarray(want.maxs, np.float32).reshape(-1))
    assert ins.mins.shape == (7,) and cond.mins.shape == (20,)


@pytest.fixture(scope="module")
def student():
    with open(pys.STUDENT, "rb") as f:
        params = pickle.load(f)
    jm = JaxUnet(conditioning_type="default", cfg_indicator=True, **PANDA_STUDENT_CONFIG)
    return jm, params, load_panda_student(pys.STUDENT, device="cpu")


def test_load_panda_student_matches_jax_forward_and_plans(student):
    """The committed student's forward against JAX's; its plans of shared
    memory: one row-set fits one block (154,764 B for the pass and the
    chain, 164,992 and 175,744 B for the episode at K = 1 and 4, 218,800 at
    16), two row-sets do not (304,780 B; 321,360 at K = 1)."""
    jm, params, tm = student
    assert tm.cfg_indicator and sum(p.numel() for p in tm.parameters()) == 1_016_615
    rng = np.random.RandomState(7)
    x = rng.randn(2, 128, 7).astype(np.float32)
    t = np.array([23, 7], np.int32)
    ctx = rng.randn(2, 20).astype(np.float32)
    mask = np.zeros((2, 1), np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, x, t, ctx, mask))
    got = tm(_t(x), _t(t.astype(np.int64)), _t(ctx), _t(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    packed = up.pack_unet(tm, "cpu")
    assert len(up.cluster_split(packed).convs) > 0
    assert packed.chain_smem_bytes(1) == 154_764 and packed.chain_smem_bytes(2) == 304_780
    assert [packed.episode_smem_bytes(k, 1) for k in (1, 4, 16)] == [164_992, 175_744, 218_800]
    assert packed.episode_smem_bytes(16, 1) <= up.SMEM_LIMIT < packed.chain_smem_bytes(2)
    assert packed.episode_smem_bytes(1, 2) == 321_360
    m1, m2 = (packed.metas[nb].numpy() for nb in (1, 2))
    plan = [up.M_BUF, up.M_XS, up.M_EPS, up.M_STATS, up.M_SMEM, *range(up.M_SKIP, up.M_DOWN),
            up.M_EP_FILM, up.M_EP_MC, up.M_EP_MISC, up.M_EP_SMEM]
    rest = np.setdiff1d(np.arange(up.M_LEN), plan)
    np.testing.assert_array_equal(m1[rest], m2[rest])  # the architecture and the weights alike
    assert m1[up.M_BUF] * 2 == m2[up.M_BUF]


def test_cfg_builders_refuse_the_panda_shape_and_ddim_kernels_take_one_row_set(student):
    """At the panda shape the CFG chain's two-row-set plan does not fit one
    block, so its builder takes the plan in turns (158,348 B per CTA), and
    the CFG episode's panda entry runs in turns (174,928 B at K = 1); past
    K = 17 its plan does not fit either, and the builder refuses it
    (ValueError naming the bytes and the limit), on the CPU too, as it
    refuses a cart-pole entry, which runs two row-sets only, at horizon 128.
    The U-Net pass, the DDIM chain and the DDIM episode launch with the
    one-row-set plan."""
    tm = student[2]
    sched = make_schedule("exponential", 25)
    plant, cost = get_plant("panda")
    chain = make_fused_cfg_chain(tm, sched, n_samples=1, device="cpu")
    assert (chain.plan, chain.entry, chain.smem_bytes) == (up.TURNS, "cfg_chain_turns", 158_348)
    ctx = arm.make_panda_context()
    cfg_ep = make_fused_cfg_episode(chain.packed, sched, *ps.panda_stats(), plant, cost, n_steps=2,
                                    state_to_condition=ctx, device="cpu")
    assert (cfg_ep.name, cfg_ep.plan, cfg_ep.smem_bytes) == ("cfg_episode_panda", up.TURNS,
                                                             174_928)
    assert cfg_ep.meta is chain.packed.metas[up.TURNS]
    with pytest.raises(ValueError, match="over the 232448 B"):  # K = 18: past the limit
        make_fused_cfg_episode(chain.packed, sched, *ps.panda_stats(), plant, cost, n_steps=2,
                               n_candidates=18, state_to_condition=ctx, device="cpu")
    # the CFG episode's plan at horizon 128 for a plant whose entry runs two row-sets only
    wide = TemporalUnet(state_dim=1, n_support_points=128, unet_input_dim=32, dim_mults=(1, 2, 4),
                        context_dim=5, cfg_indicator=True)
    with pytest.raises(ValueError, match="over the 232448 B"):
        make_fused_cfg_episode(wide, sched, *_swingup_stats(), *_swingup(), n_steps=2,
                               device="cpu")
    packed = up.pack_unet(tm, "cpu")
    unet = make_fused_unet(packed, batch_size=2, device="cpu")
    chain = make_fused_ddim_chain(packed, sched, [23], n_samples=16, device="cpu")
    ep = make_fused_ddim_episode(packed, sched, [23], *ps.panda_stats(), plant, cost, n_steps=2,
                                 n_candidates=4, selection_horizon=16,
                                 state_to_condition=arm.make_panda_context(), device="cpu")
    for w in (unet, chain, ep):
        assert w.meta is packed.metas[1]
    assert unet.smem_bytes == chain.smem_bytes == 154_764 and ep.smem_bytes == 175_744
    # the episode's entry, its consts table (C_LEN of ddim_episode_panda.cu) and its refusals
    assert ep.name == "ddim_episode_panda" and ep.consts.numel() == 2 * 20 + 2 * 7 + 3 * 14 + 2 * 7 + 1 + 140 + 43
    with pytest.raises(NotImplementedError, match="panda_context, not identity"):
        make_fused_ddim_episode(packed, sched, [23], *ps.panda_stats(), plant, cost, n_steps=2,
                                device="cpu")
    with pytest.raises(ValueError, match="over the 232448 B"):  # K = 32: past the limit
        ep32 = make_fused_ddim_episode(packed, sched, [23], *ps.panda_stats(), plant, cost,
                                       n_steps=1, n_candidates=32,
                                       state_to_condition=arm.make_panda_context(), device="cpu")
        ep32.cluster.require_fit(ep32.smem_bytes, "cpu")


def test_kernel_twins_are_bit_equal_to_torch():
    """``PandaRbd::step``'s numpy twin, given torch's sin, cos and sqrt,
    gives the torch ``panda_rbd_unrolled`` step's bits; ``PandaContext``'s
    twin (the FK carried with its derivative along qd) gives the torch map
    within 1e-6 (the torch FK multiplies 4 x 4 matrices, the kernel 3 x 4
    pieces in another order)."""
    x, u, _, _ = _states(32, seed=3)
    plant = arm.panda_rbd_unrolled()
    pc = np.float32([plant.dt, *plant.device_consts])
    tf = lambda f: (lambda v: f(torch.tensor(v)).numpy())
    # torch's vectorised float32 sqrt, as the batched step takes it
    tsqrt = lambda v: torch.sqrt(torch.full((32,), float(v)))[0].numpy()
    twin = np.stack([panda_rbd_step_f32(x[i], u[i], pc, tf(torch.sin), tf(torch.cos), tsqrt)
                     for i in range(len(x))])
    np.testing.assert_array_equal(twin, plant.step(_t(x), _t(u)).numpy())
    ctx = arm.make_panda_context()
    got = np.stack([panda_context_f32(x[i], np.float32(ctx.device_consts)) for i in range(len(x))])
    np.testing.assert_allclose(got, ctx(_t(x)).numpy(), rtol=1e-6, atol=1e-6)


def _swingup_stats():
    from mpc_via_diffusion_model_tpu_torch.data import NormalizerStats
    return (NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0)),
            NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0)))


def _swingup():
    return get_plant("cartpole_virtual_swingup")


def _narrow(seed: int = 0) -> TemporalUnet:
    """A randomised U-Net of the panda's shape (horizon 128, 7 channels,
    context 20, three levels) at width 8, the narrowest the cluster split
    takes (8 groups of every GroupNorm)."""
    cfg = dict(PANDA_STUDENT_CONFIG, unet_input_dim=8)
    jm = JaxUnet(conditioning_type="default", cfg_indicator=True, **cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 128, 7)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 20)), jnp.zeros((1, 1)))
    tm = TemporalUnet(cfg_indicator=True, **cfg)
    tm.load_state_dict(from_flax_params(randomize(shapes, seed, scale=0.2)))
    return tm.eval()


@pytest.mark.parametrize("kernel", ["fused_unet", "ddim_chain"])
def test_one_row_set_plan_at_h128_is_race_free_and_matches_plain(student, kernel):
    """The U-Net pass's and the DDIM chain's programs at horizon 128 on the
    committed student at full width, in the images of the one-row-set plan:
    the race check on 8 NaN-filled images, the output against the plain
    version (1e-4), the barrier counts of three levels (29 per pass, plus
    the start and exit barriers)."""
    tm = student[2]
    sched = make_schedule("exponential", 25)
    rng = np.random.RandomState(11)
    ctx = _t(rng.uniform(-1, 1, (1, 20)).astype(np.float32))
    if kernel == "fused_unet":
        fused = make_fused_unet(tm, batch_size=1, device="cpu")
        x = _t(rng.randn(1, 128, 7).astype(np.float32))
        t = torch.tensor([23])
        mask = torch.zeros((1, 1))
        with torch.no_grad():
            films = fused.films(tm.conditioning(t, ctx, mask)).numpy()
            want = tm.features(x, tm.conditioning(t, ctx, mask)).numpy()
        y, barriers = emulate_fused_unet_kernel(fused.packed, fused.cluster.weights, films, x.numpy())
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)
        assert barriers == [2 + 29]
        return
    chain = make_fused_ddim_chain(tm, sched, [23], n_samples=1, device="cpu")
    x_init = _t(rng.randn(*chain.noise_shape).astype(np.float32))
    want = chain.plain(ctx, x_init).numpy()
    with torch.no_grad():
        films = chain.films(ctx).numpy()
    got, barriers = emulate_ddim_chain_kernel(chain.packed, chain.cluster.weights, films,
                                              x_init.numpy(), chain.coefs.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert barriers == [2 + 29]


@pytest.mark.parametrize("k,sel_h", [(1, None), (2, 4)])
def test_emulated_panda_episode_matches_plain(k, sel_h):
    """``ddim_episode_panda``'s program in numpy (the one-row-set plan at
    horizon 128, the race check, ``PandaRbd``'s and ``PandaContext``'s
    twins as its plant and condition map, the selection QuadraticCost) on a
    narrow randomised U-Net against the plain episode, whose plant is
    ``panda_rbd_unrolled`` and map ``make_panda_context``: 2 replans, K = 1
    and K = 2 scored over 4 steps; the chosen candidates equal."""
    tm = _narrow()
    plant, cost = get_plant("panda")
    ep = make_fused_ddim_episode(tm, make_schedule("exponential", 25), [23], *ps.panda_stats(),
                                 arm.panda_rbd_unrolled(), cost, n_steps=2, n_candidates=k,
                                 selection_horizon=sel_h,
                                 state_to_condition=arm.make_panda_context(), device="cpu")
    noise = _t(np.random.RandomState(5).randn(*ep.noise_shape).astype(np.float32))
    x0 = pys.x0()
    want = ep.plain(_t(x0), noise)
    *got, barriers = emulate_ddim_episode_kernel(
        ep.packed, ep.weights, ep.t_embs.numpy(), noise.numpy(), ep.coefs.numpy(),
        ep.consts.numpy(), x0, k, ep.selection_horizon, 2, plant_step=panda_plant_step,
        condition=panda_context_condition())
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        assert np.all(np.isfinite(g)), name
        _close(name, g, w_.numpy())
    np.testing.assert_array_equal(got[3], want[3].numpy())
    assert barriers == 2 + 29 * 2 * k


def _u_unit() -> np.ndarray:
    """The controls' half range: normalized units are controls divided by it."""
    return 0.5 * (np.float32(ps.INPUTS_MAXS) - np.float32(ps.INPUTS_MINS))


def _close(name, got, want):
    """Within TOL, the controls (``u_*``) in normalized units."""
    got, want = np.asarray(got), np.asarray(want)
    if name.startswith("u_"):
        got, want = got / _u_unit(), want / _u_unit()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)


def _jax_stats():
    return (JaxStats("limits", jnp.asarray(ps.INPUTS_MINS, jnp.float32),
                     jnp.asarray(ps.INPUTS_MAXS, jnp.float32)),
            JaxStats("limits", jnp.asarray(ps.CONDITION_MINS, jnp.float32),
                     jnp.asarray(ps.CONDITION_MAXS, jnp.float32)))


def _jax_noise(key, k: int, n_steps: int) -> np.ndarray:
    """(n_steps, K, 128, 7): each replan's initial draw from its key of
    ``jax.random.split``, as the JAX loop and episode draw it."""
    return np.stack([np.array(jax.random.normal(kk, (k, 128, 7), jnp.float32))
                     for kk in jax.random.split(key, n_steps)])


def _jax_loop(student, plant, k, sel_h, n_steps):
    jm, params, _ = student
    jsched = jax_make_schedule("exponential", 25)
    sampler = jax_student_sampler(jsched, jm.apply, [23])
    _, jcost = jax_get_plant("panda")
    loop = jax_closed_loop(JaxDiffusion(schedule=jsched), jm.apply, *_jax_stats(), plant, jcost,
                           horizon=128, n_steps=n_steps, n_candidates=k,
                           sample_override=lambda ctx, kk: sampler(params, ctx, kk, (k, 128, 7)),
                           state_to_condition=jarm.make_panda_context(), selection_horizon=sel_h)
    return jax.jit(lambda x0, kk: loop(params, x0, kk))


@pytest.mark.parametrize("k,sel_h", [(1, None), (3, 8)])
def test_chain_split_loop_matches_jax(student, k, sel_h):
    """The student at full width through the port's make_closed_loop with
    its plain DDIM sampler, the rigid-body arm and the context map, 3
    replans, K = 1 and K = 3 scored over 8 steps, against the JAX package's
    loop on JAX's draws."""
    n_steps = 3
    key = jax.random.PRNGKey(20 + k)
    x0 = pys.x0()
    want = _jax_loop(student, jax_get_plant("panda")[0], k, sel_h, n_steps)(jnp.asarray(x0), key)
    tm = student[2]
    sched = make_schedule("exponential", 25)
    plant, cost = get_plant("panda")
    got = make_closed_loop(GaussianDiffusion(sched), tm, *ps.panda_stats(), plant, cost,
                           horizon=128, n_steps=n_steps, n_candidates=k,
                           state_to_condition=arm.make_panda_context(),
                           sample_override=make_student_ddim_sampler(sched, tm, [23]),
                           selection_horizon=sel_h, noise_shape=(k, 128, 7), device="cpu")(
        _t(x0), _t(_jax_noise(key, k, n_steps)))
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        _close(name, getattr(got, name).numpy(), getattr(want, name))


@pytest.mark.parametrize("k,sel_h", [(1, None), (4, 16)])
def test_plain_panda_episode_matches_jax_loop(student, k, sel_h):
    """The panda entry's plain episode (``panda_rbd_unrolled``,
    ``make_panda_context``) at full width against the JAX package's loop,
    which its episode kernel matches step for step
    (ops/fused_episode.py:161-164), on JAX's draws: 3 replans, K = 1 and
    K = 4 scored over 16 steps, the bench's rows. The JAX loop steps the
    scan-and-solve plant, which the JAX package holds its unrolled one to at
    fp32 round-off: XLA takes ~25 s to compile the unrolled step (the slow
    yardstick test runs it)."""
    n_steps = 3
    key = jax.random.PRNGKey(30 + k)
    x0 = pys.x0()
    want = _jax_loop(student, jax_get_plant("panda")[0], k, sel_h, n_steps)(jnp.asarray(x0), key)
    _, cost = get_plant("panda")
    ep = make_fused_ddim_episode(student[2], make_schedule("exponential", 25), [23],
                                 *ps.panda_stats(), arm.panda_rbd_unrolled(), cost,
                                 n_steps=n_steps, n_candidates=k, selection_horizon=sel_h,
                                 state_to_condition=arm.make_panda_context(), device="cpu")
    got = ep(_t(x0), _t(_jax_noise(key, k, n_steps)))
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got,
                           (want.x_track, want.u_track, want.stage_costs)):
        _close(name, g.numpy(), w_)


def test_yardstick_is_consistent_and_bounded():
    """The yardstick's rows: ten costs each, their means, the cut row's
    prefixes below its costs, every bound positive and met by the yardstick
    itself; the divergence loop is the runtime loop over a batch of starts
    (2 starts, 2 replans, K = 2)."""
    from mpc_via_diffusion_model_tpu_torch.scripts import panda_divergence as div
    assert set(pys.COSTS) == set(pys.ROWS) == set(pys.BOUNDS)
    for row, costs in pys.COSTS.items():
        assert len(costs) == pys.N_SEEDS and pys.MEAN10[row] == pytest.approx(np.mean(costs))
        assert pys.within(row, costs, pys.PREFIX_COSTS.get(row))
        assert all(b > 0 for b in pys.BOUNDS[row].values())
        assert set(pys.BOUNDS[row]) == ({"mean10", "prefix"} if row in pys.PREFIX_STEPS
                                        else {"mean10"})
    assert all(p < c for p, c in zip(pys.PREFIX_COSTS["k16_selh32"], pys.COSTS["k16_selh32"]))
    tm = load_panda_student(pys.STUDENT, device="cpu")
    starts = np.stack([pys.x0(), pys.x0() * 0.5])
    noise = torch.randn((2, 2, 2, 128, 7), generator=torch.Generator().manual_seed(0))
    plant, cost = get_plant("panda")
    got = div.batched_stage_costs(tm, plant, 2, 8, _t(starts), noise)
    sched = make_schedule("exponential", 25)
    loop = make_closed_loop(GaussianDiffusion(sched), tm, *ps.panda_stats(), plant, cost,
                            horizon=128, n_steps=2, n_candidates=2,
                            state_to_condition=arm.make_panda_context(),
                            sample_override=make_student_ddim_sampler(sched, tm, [23]),
                            selection_horizon=8, noise_shape=(2, 128, 7), device="cpu")
    for i in range(2):
        np.testing.assert_allclose(got[i].numpy(), loop(_t(starts[i]), noise[i]).stage_costs.numpy(),
                                   rtol=TOL, atol=TOL)


@pytest.mark.slow
def test_yardstick_regenerates(student):
    """The JAX package's bench_panda_student protocol on the CPU gives every
    literal of (a) and (b) of data/panda_yardstick.py (~2.5 min)."""
    keys = jax.random.split(jax.random.PRNGKey(pys.KEY_SEED), pys.N_SEEDS)
    x0 = jnp.asarray(pys.x0())
    for row, (k, sel_h) in pys.ROWS.items():
        plant = jarm.panda_rbd_unrolled() if row.startswith("episode") else jax_get_plant("panda")[0]
        loop = _jax_loop(student, plant, k, sel_h, pys.N_STEPS)
        stages = [np.asarray(loop(x0, keys[i]).stage_costs, np.float32) for i in range(pys.N_SEEDS)]
        assert tuple(float(s.astype(np.float64).sum()) for s in stages) == pys.COSTS[row]
        if row in pys.PREFIX_STEPS:
            assert tuple(float(s[:pys.PREFIX_STEPS[row]].astype(np.float64).sum())
                         for s in stages) == pys.PREFIX_COSTS[row]


def test_bench_script_reports_outside_artifacts():
    from mpc_via_diffusion_model_tpu_torch.scripts import bench_panda_student as bench
    with pytest.raises(SystemExit, match="not artifacts/"):
        bench.main(["--out", str(ROOT / "artifacts" / "onpolicy_panda" / "bench.json"),
                    "--device", "cpu"])


@pytest.mark.slow
def test_bench_script_runs_on_cpu(tmp_path):
    """Every row of the port's bench at toy depth (~1 min): its 10 episodes
    of 2 replans, K = 1 and 2 through the chain split and the episode, the
    rates of one batch and one repetition."""
    from mpc_via_diffusion_model_tpu_torch.scripts import bench_panda_student as bench
    out = bench.main(["--device", "cpu", "--steps", "2", "--sustained-steps", "2",
                      "--candidates", "2", "--sel-h", "4", "--whole-episode",
                      "--rate-batches", "1", "--sustained-reps", "1",
                      "--out", str(tmp_path / "bench.json")])
    for tag in ("k1", "k2_selh4", "episode", "episode_k4_selh16"):
        assert np.isfinite(out[f"{tag}_cost_mean10"]) and out[f"{tag}_hz_pipelined"] > 0
        assert out[f"{tag}_hz_sustained"] > 0 and len(out[f"{tag}_costs"]) == 10
    assert out["card"] == "cpu" and (tmp_path / "bench.json").exists()
    # the chain split and the episode run the same student on the same draws; the plants differ
    # by float32 round-off (panda_rbd against panda_rbd_unrolled)
    np.testing.assert_allclose(out["episode_costs"], out["k1_costs"], rtol=1e-4)
