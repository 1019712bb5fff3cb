"""Distillation's training half in the PyTorch port against the JAX package,
on the CPU: ``distill_pair_tables`` bit for bit, ``distill_loss`` and its
gradient, ``make_distill_step`` under ``make_scanned_train_steps`` (both EMA
phases, the NaN guard), the student sampler without the clip, the recipe
``scripts/distill_flagship.py`` at toy size, and the yardstick
``data/distill_yardstick.py``.

The small model is the flagship's architecture cut to H = 16 and width 16;
both sides see the same weights (``init_like_flax`` from a numpy seed,
carried into flax by ``to_flax_params``) and the same draws (JAX's own, from
its keys, staged into the port). Tolerances: the loss and every gradient
element within rtol = atol = 1e-4 of JAX's in float32 (relative to the
largest element for the gradient); in float64 (``_x64``: JAX in float64
and the port's time embedding JAX's float32 values, as
``tests/test_torch_port_train.py`` explains) within 1e-10, states after five
steps within 1e-9 of each buffer's largest value.
"""
import collections
import contextlib
import functools
import json
import math
import pickle
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu import train as jt
from mpc_via_diffusion_model_tpu.control import make_nmpc_closed_loop as jax_nmpc
from mpc_via_diffusion_model_tpu.control.runtime import make_ampc_closed_loop as jax_ampc_loop
from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_schedule
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.diffusion import distillation as jdist
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu.models import AMPCNet as JaxAmpc
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu.models import layers as jax_layers
from mpc_via_diffusion_model_tpu.solvers import ilqr as jax_ilqr
from mpc_via_diffusion_model_tpu_torch import train as pt
from mpc_via_diffusion_model_tpu_torch.control import make_nmpc_closed_loop
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import distill_yardstick as dy
from mpc_via_diffusion_model_tpu_torch.data.flagship_expert_yardstick import expert_gaps
from mpc_via_diffusion_model_tpu_torch.data.teacher_stats import teacher_stats
from mpc_via_diffusion_model_tpu_torch.diffusion import distillation as dist
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_collect_cost,
                                                        cartpole_virtual_swingup)
from mpc_via_diffusion_model_tpu_torch.models import (TemporalUnet, from_flax_params,
                                                      init_like_flax, to_flax_params)
from mpc_via_diffusion_model_tpu_torch.models import layers as port_layers
from mpc_via_diffusion_model_tpu_torch.scripts import distill_divergence, distill_flagship
from mpc_via_diffusion_model_tpu_torch.solvers import ILQRConfig

torch.set_num_threads(1)

TEACHER_ARCH = dict(state_dim=1, n_support_points=dy.HORIZON, unet_input_dim=32,
                    dim_mults=(1, 2, 4), context_dim=5)


def _tree_checksum(tree):
    return dy.checksum(torch.from_numpy(np.asarray(leaf, np.float32))
                       for leaf in jax.tree_util.tree_leaves(tree))


class _StagedKeys:
    """Substitutes for ``jax.random.split``, ``randint`` and ``normal`` while
    the JAX package's distill step is traced and run: its key is the pair
    (j, noise) of staged draws, which ``split`` hands to both halves,
    ``randint`` returns the first of and ``normal`` the second. Counts the
    calls, so a test can tell that JAX drew nothing of its own."""

    def __init__(self):
        self.calls = collections.Counter()

    def split(self, key, num=2):
        self.calls["split"] += 1
        assert num == 2 and isinstance(key, tuple), "a key the substitutes did not stage"
        return key, key

    def randint(self, key, shape, minval, maxval, dtype=jnp.int32):
        self.calls["randint"] += 1
        assert tuple(key[0].shape) == tuple(shape)
        return key[0].astype(dtype)

    def normal(self, key, shape=(), dtype=jnp.float32):
        self.calls["normal"] += 1
        assert tuple(key[1].shape) == tuple(shape)
        return key[1].astype(dtype)

    @contextlib.contextmanager
    def patched(self):
        with mock.patch.multiple(jax.random, split=self.split, randint=self.randint,
                                 normal=self.normal):
            yield


def _jax_teacher_unet():
    return JaxUnet(**TEACHER_ARCH, conditioning_type="default", cfg_indicator=True)


def _jax_stats(stats):
    return JaxStats("limits", jnp.asarray(stats.mins.numpy()), jnp.asarray(stats.maxs.numpy()))


def jax_distill_steps():
    """Yardstick (a): the JAX package's distill steps on the staged draws."""
    teacher = jax.tree_util.tree_map(jnp.asarray, dy.load_teacher_params())
    jm = _jax_teacher_unet()
    schedule = jax_schedule("exponential", dy.T)
    opt = jt.make_optimizer(dy.LR)
    x_all, c_all = dy.synthetic_data()
    draws = dy.staged_draws()
    staged = _StagedKeys()
    losses, skipped, sums = [], [], {}
    times, params, n = jdist.ddim_time_grid(dy.T, t_start=dy.T_START), teacher, 0
    with staged.patched():
        for n_steps, cfg in ((dy.ROUND0_STEPS, True), (dy.ROUND1_STEPS, False)):
            step_fn, student_times = jdist.make_distill_step(schedule, jm.apply, opt, params, times,
                                                             w=dy.W, teacher_cfg=cfg)
            step = jax.jit(step_fn)
            state = jt.TrainState(params, jax.tree_util.tree_map(jnp.copy, params),
                                  opt.init(params), jnp.int32(0))
            for _ in range(n_steps):
                idx = draws["idx"][n]
                key = (jnp.asarray(draws["j"][n].astype(np.int32)), jnp.asarray(draws["noise"][n]))
                state, met = step(state, jnp.asarray(x_all[idx]), jnp.asarray(c_all[idx]), key)
                n += 1
                losses.append(float(met["loss"]))
                skipped.append(bool(met["update_skipped"]))
                if n in dy.CHECK_STEPS:
                    sums[n] = {"params": _tree_checksum(state.params),
                               "ema": _tree_checksum(state.ema_params)}
            params, times = state.ema_params, student_times
    # each round's trace draws through every substitute, and JAX drew nothing else
    assert staged.calls == {"split": 2, "randint": 2, "normal": 2}, staged.calls
    return {"LOSSES": losses, "CHECKSUMS": sums, "UPDATE_SKIPPED": skipped}


def jax_expert():
    """Yardstick (b): the distillation's expert, the JAX package's NMPC loop at H = 64."""
    loop = jax.jit(jax_nmpc(jax_cp.cartpole_virtual_swingup(), jax_cp.cartpole_virtual_collect_cost(),
                            jax_ilqr.ILQRConfig(horizon=dy.HORIZON,
                                                n_iterations=dy.EXPERT_ITERATIONS),
                            n_steps=dy.N_EXPERT_STEPS, u_init_scale=dy.EXPERT_KICK,
                            warm_start=False))
    run = loop(jnp.asarray(dy.X0, jnp.float32))
    stages = np.asarray(run.stage_costs, np.float64)
    return {"EXPERT_U_TRACK": np.asarray(run.u_track)[:, 0].tolist(),
            "EXPERT_X_TRACK": np.asarray(run.x_track).reshape(-1).tolist(),
            "EXPERT_STAGE_COSTS": stages.tolist(), "EXPERT_COST": math.fsum(stages.tolist())}


def jax_ampc():
    """Yardstick (c): the JAX package's AMPC loop on ampc_params() and the teacher's statistics."""
    ins, cond = teacher_stats()
    loop = jax.jit(jax_ampc_loop(JaxAmpc(horizon=dy.HORIZON).apply, _jax_stats(ins),
                                 _jax_stats(cond), jax_cp.cartpole_virtual_swingup(),
                                 jax_cp.cartpole_virtual_collect_cost(), n_steps=dy.N_EXPERT_STEPS))
    run = loop(jax.tree_util.tree_map(jnp.asarray, dy.ampc_params()),
               jnp.asarray(dy.X0, jnp.float32))
    stages = np.asarray(run.stage_costs, np.float64)
    return {"AMPC_U_TRACK": np.asarray(run.u_track)[:, 0].tolist(),
            "AMPC_STAGE_COSTS": stages.tolist(), "AMPC_COST": math.fsum(stages.tolist())}


def jax_yardstick():
    """Every literal of data/distill_yardstick.py's (a)-(c), by the JAX package on the CPU."""
    assert float(jax_cp.theta_to_red_theta(jnp.float32(3.0))) == dy.X0[4]
    return {**jax_ampc(), **jax_expert(), **jax_distill_steps()}


# --------------------------------------------------------------------------- the pair tables

def _halvings(grid):
    out = [grid]
    while len(out[-1]) > 2:
        out.append(dist.halve_times(out[-1]))
    return out


PAIR_GRIDS = ([(25, g) for g in _halvings(list(range(23, -1, -1)))]
              + [(25, g) for g in _halvings(list(range(24, -1, -1)))]
              + [(25, [23]), (10, list(range(7, -1, -1))), (10, list(range(8, -1, -1)))])


@pytest.mark.parametrize("n_steps,grid", PAIR_GRIDS,
                         ids=[f"T{n}_{g[0]}-{g[-1]}_len{len(g)}" for n, g in PAIR_GRIDS])
def test_pair_tables_equal_jax(n_steps, grid):
    """distill_pair_tables equals the JAX package's bit for bit: the grids
    [23..0] and [24..0] and their halvings down to a one-eval student, a
    one-entry grid, and both parities of the last pair (JAX's own cases)."""
    want = jdist.distill_pair_tables(jax_schedule("exponential", n_steps), grid)
    got = dist.distill_pair_tables(make_schedule("exponential", n_steps), grid)
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == (np.int64 if k in ("t_hi", "mid") else np.float32), k
        np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)
    if grid == list(range(grid[0], -1, -1)):   # every timestep down to 0: the last pair's parity
        if len(grid) % 2 == 0:                    # even: the two-step (1 -> 0 -> -1) chain
            assert int(got["mid"][-1]) == 0 and float(got["b_c1"][-1]) == 1.0
        else:                                     # odd: one recon, then the identity
            assert float(got["b_c1"][-1]) == 0.0 and float(got["b_c2"][-1]) == 1.0
    assert dist.make_distill_step(make_schedule("exponential", n_steps), torch.nn.Linear(1, 1),
                                  pt.make_optimizer(1e-3), {}, grid)[1] == dist.halve_times(grid)


# --------------------------------------------------------------------------- the loss on a small model

H, B, T = 16, 24, 25
SMALL = dict(state_dim=1, n_support_points=H, unet_input_dim=16, dim_mults=(1, 2, 4), context_dim=5)
TEACHER_GRID = dist.ddim_time_grid(T, t_start=23)


@functools.lru_cache(maxsize=None)
def _jax_embedding(dim):
    return jax.jit(jax_layers.SinusoidalPosEmb(dim).apply)


@contextlib.contextmanager
def _x64():
    """JAX in float64, and the port's time embedding the JAX package's jitted float32 values."""
    def forward(self, t):
        emb = _jax_embedding(self.dim)({}, jnp.asarray(t.cpu().numpy()))
        return torch.from_numpy(np.asarray(emb)).to(t.device)

    with jax.enable_x64(True), mock.patch.object(port_layers.SinusoidalPosEmb, "forward", forward):
        yield


def _small(seed, dtype=torch.float32):
    """(port model, flax params) of the small model from RandomState(seed)."""
    tm = init_like_flax(TemporalUnet(**SMALL, cfg_indicator=True), np.random.RandomState(seed))
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return tm.to(dtype), jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), to_flax_params(tm))


def _data(seed=0, n=B, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, (n, H, 1)).astype(dtype), rs.uniform(-1, 1, (n, 5)).astype(dtype))


def _jax_draws(key, x, n_pairs):
    """The draws of the JAX distill loss from its key, staged for the port."""
    k_j, k_noise = jax.random.split(key)
    j = jax.random.randint(k_j, (x.shape[0],), 0, n_pairs)
    noise = jax.random.normal(k_noise, x.shape, x.dtype)
    return {"j": torch.from_numpy(np.asarray(j).astype(np.int64)),
            "noise": torch.from_numpy(np.array(noise))}


def _grad_capture():
    """An optax transformation whose state after a step is that step's gradient."""
    import optax
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _guide(x, ctx):
    return 0.05 * torch.tanh(x) * (1.0 + 0.0 * ctx.sum())


def _jax_guide(x, ctx):
    return 0.05 * jnp.tanh(x) * (1.0 + 0.0 * ctx.sum())


# each case compiles its own JAX step (~15 s): both values of each flag, and the guide's gate
LOSS_CASES = {
    "cfg_clip": dict(teacher_cfg=True, clip_denoised=True),
    "cond_noclip": dict(teacher_cfg=False, clip_denoised=False),
    "cfg_guide_gated": dict(teacher_cfg=True, clip_denoised=True, guide=True, t_start_guide=12.0),
    "cfg_guide_off": dict(teacher_cfg=True, clip_denoised=True, guide=True, t_start_guide=-1.0),
}


@functools.lru_cache(maxsize=None)
def _loss_pair(case, dtype=torch.float32, key_seed=4):
    """(port loss, port gradient by name, JAX loss, JAX gradient by name, draws) of one case,
    the student's weights RandomState(2)'s and the teacher's RandomState(1)'s."""
    kw = dict(LOSS_CASES[case])
    guide, key = kw.pop("guide", False), jax.random.PRNGKey(key_seed)
    tm, jparams = _small(2, dtype)
    _, jteacher = _small(1, dtype)
    teacher = {n: v.to(dtype) for n, v in from_flax_params(
        jax.tree_util.tree_map(np.asarray, jteacher), dtype=None).items()}
    npdt = np.float64 if dtype == torch.float64 else np.float32
    x, c = _data(dtype=npdt)
    jm = JaxUnet(**SMALL, conditioning_type="default", cfg_indicator=True)
    step_fn, _ = jdist.make_distill_step(jax_schedule("exponential", T), jm.apply, _grad_capture(),
                                         jteacher, TEACHER_GRID, w=0.3,
                                         guide_fn=_jax_guide if guide else None, **kw)
    jstate = jt.TrainState(jparams, jparams, _grad_capture().init(jparams), jnp.int32(0))
    jstate, jmet = jax.jit(step_fn)(jstate, jnp.asarray(x), jnp.asarray(c), key)
    loss_fn = dist.distill_loss(make_schedule("exponential", T), tm, teacher, TEACHER_GRID, w=0.3,
                                guide_fn=_guide if guide else None, **kw)
    layout = pt.ParamLayout.of(tm)
    draws = _jax_draws(key, jnp.asarray(x), len(dist.halve_times(TEACHER_GRID)))
    loss, g = pt.value_and_grad(loss_fn, layout, layout.flatten(dict(tm.named_parameters())),
                                torch.from_numpy(x), torch.from_numpy(c), draws)
    jg = from_flax_params(jax.tree_util.tree_map(np.asarray, jstate.opt_state), dtype=None)
    return float(loss), layout.views(g), float(jmet["loss"]), jg, draws


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_distill_loss_and_gradient_match_jax(case):
    """distill_loss and its gradient against the JAX step's on the draws of
    JAX's own key, float32: the loss within rtol 1e-4, every gradient
    element within 1e-4 of the largest (rtol = atol = 1e-4 on the scaled
    gradient). A CFG teacher with the clip, a conditional one without, a
    guide gated at t_start_guide 12 (it moves the loss) and one gated off
    (its loss the unguided one's exactly)."""
    loss, g, jloss, jg, draws = _loss_pair(case)
    assert set(g) == set(jg) and draws["j"].max() > 0
    np.testing.assert_allclose(loss, jloss, rtol=1e-4, atol=0)
    scale = max(v.abs().max().item() for v in jg.values())
    assert scale > 0
    for name in g:
        np.testing.assert_allclose(g[name].numpy() / scale, jg[name].numpy() / scale, rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    if case == "cfg_guide_off":
        assert loss == _loss_pair("cfg_clip")[0]
    if case == "cfg_guide_gated":
        assert abs(loss / _loss_pair("cfg_clip")[0] - 1) > 1e-3


def test_distill_loss_float64_matches_jax_to_rounding():
    """The same in float64 on both sides (the port's time embedding JAX's
    float32 values): the loss within 1e-12, the gradient within 1e-10 of
    its largest element, with the clip and the CFG teacher."""
    with _x64():
        loss, g, jloss, jg, _ = _loss_pair("cfg_clip", torch.float64)
    np.testing.assert_allclose(loss, jloss, rtol=1e-12)
    scale = max(v.abs().max().item() for v in jg.values())
    for name in g:
        np.testing.assert_allclose(g[name].numpy() / scale, jg[name].numpy() / scale, rtol=0,
                                   atol=1e-10, err_msg=name)


# --------------------------------------------------------------------------- steps against JAX's

START_EMA, EVERY_EMA, N_INNER, N_DATA = 2, 2, 5, 64


@functools.lru_cache(maxsize=None)
def _jax_distill_jit(teacher_cfg=True):
    """The JAX package's distill step of the small model in float64 (teacher
    RandomState(1)'s weights, EMA from step 2, every 2), jitted once, and
    its scanned chunk of N_INNER steps."""
    with jax.enable_x64(True):
        _, jteacher = _small(1, torch.float64)
    jm = JaxUnet(**SMALL, conditioning_type="default", cfg_indicator=True)
    opt = jt.make_optimizer(1e-3)
    step_fn, _ = jdist.make_distill_step(jax_schedule("exponential", T), jm.apply, opt, jteacher,
                                         TEACHER_GRID, w=0.3, teacher_cfg=teacher_cfg,
                                         step_start_ema=START_EMA, update_ema_every=EVERY_EMA)
    chunk = jt.make_scanned_train_steps(step_fn, N_INNER)
    return opt, jax.jit(step_fn), jax.jit(chunk, static_argnums=4)


def _port_distill(dtype=torch.float64, teacher_cfg=True):
    """(port model, step, initial state, JAX state) from the same weights."""
    tm, jparams = _small(2, dtype)
    teacher_model, _ = _small(1, dtype)
    teacher = {n: p.detach() for n, p in teacher_model.named_parameters()}
    step, _ = dist.make_distill_step(make_schedule("exponential", T), tm, pt.make_optimizer(1e-3),
                                     teacher, TEACHER_GRID, w=0.3, teacher_cfg=teacher_cfg,
                                     step_start_ema=START_EMA, update_ema_every=EVERY_EMA)
    layout = pt.ParamLayout.of(tm)
    params = layout.flatten(dict(tm.named_parameters()))
    opt = pt.make_optimizer(1e-3)
    state = pt.TrainState(params, params.clone(), opt.init(params), torch.zeros((), dtype=torch.int32),
                          layout)
    jopt = _jax_distill_jit(teacher_cfg)[0]
    jstate = jt.TrainState(jparams, jax.tree_util.tree_map(jnp.copy, jparams), jopt.init(jparams),
                           jnp.int32(0))
    return tm, step, state, jstate


def _state_error(state, jstate):
    """The largest |port - JAX| / max |JAX| over the params, the EMA and Adam's moments."""
    adam = jstate.opt_state[1][0]
    err = 0.0
    for got, want in ((state.params, jstate.params), (state.ema_params, jstate.ema_params),
                      (state.opt_state.mu, adam.mu), (state.opt_state.nu, adam.nu)):
        w = state.layout.flatten(from_flax_params(jax.tree_util.tree_map(np.asarray, want),
                                                  dtype=None)).double()
        err = max(err, ((got.double() - w).abs().max() / w.abs().max()).item())
    return err


def test_five_distill_steps_in_a_chunk_match_jax():
    """Five steps of make_distill_step under make_scanned_train_steps on the
    draws JAX's scanned chunk derives from its key (per step the indices,
    then the loss's pair and noise), float64: each loss within 1e-12, the
    params, the EMA and Adam's moments within 1e-9 of each buffer's largest
    value. The EMA starts at step 2 and moves every 2, so the chunk goes
    through its hard copy (step 1), its decay (2, 4) and its hold (3, 5)."""
    n_pairs = len(dist.halve_times(TEACHER_GRID))
    with _x64():
        x_all, c_all = _data(seed=5, n=N_DATA, dtype=np.float64)
        _, jstep, jchunk = _jax_distill_jit()
        tm, step, state, jstate = _port_distill()
        key = jax.random.PRNGKey(7)
        staged = {"idx": [], "j": [], "noise": []}
        jlosses = []
        for k in jax.random.split(key, N_INNER):   # the chunk's own derivation, step by step
            k_idx, k_loss = jax.random.split(k)
            idx = np.asarray(jax.random.randint(k_idx, (B,), 0, N_DATA)).astype(np.int64)
            staged["idx"].append(torch.from_numpy(idx))
            for name, v in _jax_draws(k_loss, jnp.asarray(x_all[idx]), n_pairs).items():
                staged[name].append(v)
        jstate_c, jmean = jchunk(jstate, jnp.asarray(x_all), jnp.asarray(c_all), key, B)
        staged = {k: torch.stack(v) for k, v in staged.items()}
        chunk = pt.make_scanned_train_steps(step, N_INNER)
        state_c, losses = chunk(state, torch.from_numpy(x_all), torch.from_numpy(c_all), B, staged,
                                per_step=True)
        ema_hist, s = [], state
        for i in range(N_INNER):  # the per-step loop on the same draws: the EMA's phases
            idx = staged["idx"][i]
            before = s
            s, _ = step(s, torch.from_numpy(x_all)[idx], torch.from_numpy(c_all)[idx],
                        {"j": staged["j"][i], "noise": staged["noise"][i]})
            ema_hist.append("copy" if torch.equal(s.ema_params, s.params) and i + 1 < START_EMA
                            else "hold" if torch.equal(s.ema_params, before.ema_params) else "decay")
    assert ema_hist == ["copy", "decay", "hold", "decay", "hold"]
    assert torch.equal(s.params, state_c.params) and torch.equal(s.ema_params, state_c.ema_params)
    np.testing.assert_allclose(float(losses.mean()), float(jmean), rtol=1e-12)
    assert int(state_c.step) == int(jstate_c.step) == N_INNER
    assert _state_error(state_c, jstate_c) < 1e-9


def test_nan_batch_is_skipped_as_jax_skips_it():
    """Three single steps, the second on a batch with a NaN (conditional
    teacher, float64): the second's update is skipped on both sides (loss
    not finite, params and Adam's state kept, the step counter advanced),
    and every state equals JAX's within 1e-9."""
    n_pairs = len(dist.halve_times(TEACHER_GRID))
    with _x64():
        _, jstep, _ = _jax_distill_jit(teacher_cfg=False)
        tm, step, state, jstate = _port_distill(teacher_cfg=False)
        for i, poison in enumerate((False, True, False)):
            x, c = _data(seed=10 + i, dtype=np.float64)
            if poison:
                x[3, 2, 0] = np.nan
            key = jax.random.PRNGKey(40 + i)
            before = state
            jstate, jmet = jstep(jstate, jnp.asarray(x), jnp.asarray(c), key)
            state, met = step(state, torch.from_numpy(x), torch.from_numpy(c),
                              _jax_draws(key, jnp.asarray(x), n_pairs))
            assert bool(met["update_skipped"]) == bool(jmet["update_skipped"]) == poison
            assert int(state.step) == int(jstate.step) == i + 1
            if poison:
                assert not math.isfinite(float(met["loss"]))
                assert torch.equal(state.params, before.params)
                assert torch.equal(state.opt_state.mu, before.opt_state.mu)
                assert int(state.opt_state.count) == 1
            else:
                np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-12)
            assert _state_error(state, jstate) < 1e-9


@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
def test_student_sampler_matches_jax(clip):
    """make_student_ddim_sampler with and without the clip against the JAX
    sampler on a pinned x_init, float32, on the 3-eval grid (1e-5); without
    the clip the reconstruction leaves [-1, 1]."""
    tm, jparams = _small(2)
    jm = JaxUnet(**SMALL, conditioning_type="default", cfg_indicator=True)
    times = [23, 15, 7]
    rs = np.random.RandomState(8)
    ctx, x_init = rs.uniform(-1, 1, (3, 5)).astype(np.float32), rs.standard_normal((3, H, 1)).astype(np.float32)
    want = jdist.make_student_ddim_sampler(jax_schedule("exponential", T), jm.apply, times, clip)(
        jparams, jnp.asarray(ctx), None, (3, H, 1), x_init=jnp.asarray(x_init))
    got = dist.make_student_ddim_sampler(make_schedule("exponential", T), tm, times, clip)(
        torch.from_numpy(ctx), torch.from_numpy(x_init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (got.abs().max().item() <= 1.0) == clip


# --------------------------------------------------------------------------- the recipe at toy size

def test_distill_flagship_script_at_toy_size(tmp_path):
    """The recipe on the CPU at H = 8: a toy teacher (the flagship's
    architecture, init_like_flax from RandomState(4)) without a dataset, so
    --collect runs a 2-state grid; the expert, the teacher's baseline
    through the CFG episode's plain version and two rounds of 2 steps, each
    student saved in the flax layout, evaluated through the DDIM episode's
    plain version, and applied by the JAX package to the port's output
    (1e-5); report.json has the JAX script's keys and each route."""
    teacher_dir, out = tmp_path / "teacher", tmp_path / "out"
    teacher_dir.mkdir()
    arch = dict(TEACHER_ARCH, n_support_points=8)
    tm = init_like_flax(TemporalUnet(**arch, cfg_indicator=True), np.random.RandomState(4))
    with open(teacher_dir / "ema_params.pkl", "wb") as f:
        pickle.dump(to_flax_params(tm), f)
    report = distill_flagship.main([
        "--teacher", str(teacher_dir), "--out", str(out), "--horizon", "8", "--collect",
        "--grid-pos", "1", "--grid-theta", "2", "--collect-steps", "2", "--noisy", "1",
        "--steps-per-round", "2", "--chunk", "1", "--batch-size", "8", "--rounds", "2",
        "--eval-seeds", "1", "--eval-steps", "2", "--device", "cpu"])
    assert {"teacher", "expert_cost", "teacher_cost", "w", "rounds"} <= set(report)
    assert report["data"]["n_samples"] == 1 * 2 * 2 * 2 * 2
    assert report["teacher_eval"]["kernel"] == "cfg_episode"
    assert [r["n_evals"] for r in report["rounds"]] == [12, 6]
    for rec in report["rounds"]:
        assert {"n_evals", "times", "train_seconds", "final_loss", "cost_mean", "cost_min",
                "cost_max", "cost_ratio_vs_expert"} <= set(rec)
        assert rec["kernel"] == "ddim_episode" and rec["plain_calls"] == 1
        assert np.isfinite(rec["cost_ratio_vs_expert"]) and rec["steps"] == 2
    assert [r["teacher_cfg"] for r in report["rounds"]] == [True, False]
    assert json.loads((out / "report.json").read_text())["rounds"][1]["times"] == [23, 19, 15, 11, 7, 3]
    with open(out / "student_6eval.pkl", "rb") as f:
        student = pickle.load(f)
    assert set(student) == {"params"}
    jm = JaxUnet(**arch, conditioning_type="default", cfg_indicator=True)
    port = TemporalUnet(**arch, cfg_indicator=True)
    port.load_state_dict(from_flax_params(student))
    rs = np.random.RandomState(0)
    x, c = rs.standard_normal((2, 8, 1)).astype(np.float32), rs.standard_normal((2, 5)).astype(np.float32)
    t, mask = np.array([23, 3]), np.zeros((2, 1), np.float32)
    want = jm.apply(student, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c), jnp.asarray(mask))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(SystemExit):
        distill_flagship.main(["--out", "artifacts/distilled_port", "--device", "cpu"])


# --------------------------------------------------------------------------- the yardstick

@pytest.mark.slow
def test_yardstick_regenerates():
    """The JAX package recomputes every literal of data/distill_yardstick.py's
    (a)-(c) on the CPU (XLA's CPU code: 1e-6 relative, the checksums 1e-9),
    and no step of (a) skipped its update."""
    got = jax_yardstick()
    assert not any(got["UPDATE_SKIPPED"])
    np.testing.assert_allclose(got["LOSSES"], dy.LOSSES, rtol=1e-6)
    assert set(got["CHECKSUMS"]) == set(dy.CHECKSUMS)
    for step, sums in got["CHECKSUMS"].items():
        for k in ("params", "ema"):
            np.testing.assert_allclose(sums[k], dy.CHECKSUMS[step][k], rtol=1e-9, err_msg=f"{step} {k}")
    for name in ("EXPERT_U_TRACK", "EXPERT_X_TRACK", "EXPERT_STAGE_COSTS", "AMPC_U_TRACK",
                 "AMPC_STAGE_COSTS"):
        np.testing.assert_allclose(got[name], getattr(dy, name), rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got["EXPERT_COST"], dy.EXPERT_COST, rtol=1e-9)
    np.testing.assert_allclose(got["AMPC_COST"], dy.AMPC_COST, rtol=1e-9)


def test_port_on_cpu_follows_the_distill_yardstick():
    """Yardstick (a)'s first 2 steps at full width (the teacher at H = 64,
    batch 512) in the port on the CPU: each loss within (d)'s head bound of
    the JAX package's, the checksum after step 1 within (d)'s, no update
    skipped; and the divergence script at that depth, one run moved by one
    ulp."""
    run = distill_divergence.distill_steps(distill_divergence.teacher_model("cpu"), "cpu", 2,
                                           check=(1,))
    rel = np.abs(run["losses"] / np.asarray(dy.LOSSES[:2]) - 1)
    assert rel.max() <= dy.LOSS_BOUNDS["head"][1] and not run["skipped"].any()
    assert max(distill_divergence.checksum_gaps(run["sums"], dy.CHECKSUMS).values()) <= dy.CHECKSUM_BOUND
    out = distill_divergence.main(["--device", "cpu", "--steps", "1", "--perturbed", "1"])
    base, moved = out["runs"]
    assert base["perturbed_seed"] is None and base["vs_yardstick"]["max_1_1"] <= dy.LOSS_BOUNDS["head"][1]
    assert moved["perturbed_seed"] == 100 and moved["vs_unperturbed"]["max_1_1"] < 1e-4


def test_port_expert_follows_the_distill_yardstick():
    """Yardstick (b)'s first 3 steps in the port on the CPU (iLQR at H = 64,
    25 iterations, the collection cost, kick 5, no warm start): the summed
    cost within 1e-6 relative, controls within 1e-3 (|u| ~2,900) and states
    within 1e-5 of the JAX package's (measured: 1.1e-7, 2.4e-4, 2.4e-7)."""
    run = make_nmpc_closed_loop(cartpole_virtual_swingup(), cartpole_virtual_collect_cost(),
                                ILQRConfig(horizon=dy.HORIZON, n_iterations=dy.EXPERT_ITERATIONS),
                                n_steps=3, u_init_scale=dy.EXPERT_KICK, warm_start=False,
                                device="cpu")(torch.tensor(dy.X0))
    gaps = expert_gaps(run, 3, dy.expert_tracks())
    assert gaps["cost_rel"] <= 1e-6 and gaps["u_max"] <= 1e-3 and gaps["x_max"] <= 1e-5, gaps
