"""Training in the PyTorch port against the JAX package's trainer, on the CPU:
autograd's gradients against ``jax.grad``, train steps against
``make_train_step`` (params, Adam's moments and count, EMA), the NaN guard,
the EMA schedule, a chunk against the per-step loop and the draws of JAX's
scanned chunk, checkpoints both ways, ``to_flax_params`` and ``init_like_flax``,
``Trainer.fit``, the LMPC recipe script at toy size and the yardstick of
``data/lmpc_train_yardstick.py``.

The model is the LMPC architecture cut to ``unet_input_dim`` 8 at H = 8.
Both sides see the same initial weights (``init_like_flax`` from a numpy
seed, carried into flax by ``to_flax_params``) and the same draws (JAX's,
re-derived from its keys and staged into the port). State comparisons run
in float64 on both sides (``jax.enable_x64``) with the port's sinusoidal
time embedding replaced by the JAX package's float32 values, jitted as its
train step computes them (``_x64``): both compute it in float32 as the JAX
package does, but XLA's and torch's float32 sin and cos differ by an ulp in
93 of its 800 entries at T = 25, which moves the float64 gradient by ~2e-7 of
its largest element, and Adam turns that into +-lr wherever a gradient is
that small. With the same embedding the two agree to float64 rounding.
In float32 the port's gradient is within 6e-6 of the float64 one and JAX's
within 1.4e-5 (measured on this model), and Adam's first update is +-lr
wherever |g| >> eps, so the float32 step is compared apart from the
elements whose float64 gradient is below 1e-5 but not 0 (among them the
biases of the convs that feed a GroupNorm of one channel per group, whose
gradient is 0 but for rounding), each of which may move by up to 2 lr.
"""
import contextlib
import functools
import pickle
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu import train as jt
from mpc_via_diffusion_model_tpu.core.losses import LOSSES as JLOSSES
from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_schedule
from mpc_via_diffusion_model_tpu.data.datasets import ControlSequenceDataset as JaxDataset
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu.models import layers as jax_layers
from mpc_via_diffusion_model_tpu.solvers import lqr as jax_lqr
from mpc_via_diffusion_model_tpu_torch import train as pt
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import ControlSequenceDataset
from mpc_via_diffusion_model_tpu_torch.data import lmpc_train_yardstick as ys
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.dynamics import cartpole_lmpc, cartpole_lmpc_cost
from mpc_via_diffusion_model_tpu_torch.models import (LMPC_CONFIG, TemporalUnet,
                                                      from_flax_params, init_like_flax,
                                                      load_lmpc, to_flax_params)
from mpc_via_diffusion_model_tpu_torch.models import layers as port_layers
from mpc_via_diffusion_model_tpu_torch.scripts import flagship_lmpc, train_divergence, train_profile
from mpc_via_diffusion_model_tpu_torch.scripts.lmpc_parity import linear_matrices

torch.set_num_threads(1)

H, T, B = 8, 25, 32
SMALL = dict(state_dim=1, n_support_points=H, unet_input_dim=8, dim_mults=(1, 2, 4), context_dim=4)
LR = 3e-3
# elements of the float32 step whose float64 gradient is below 1e-5 but not 0
N_NEAR_ZERO = 243


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


def _models(seed=1, dtype=torch.float32):
    """The port's model initialized from RandomState(seed), the flax model
    and its params (the same weights)."""
    tm = init_like_flax(TemporalUnet(**SMALL, cfg_indicator=True), np.random.RandomState(seed))
    jm = JaxUnet(**SMALL, conditioning_type="default", cfg_indicator=True)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), to_flax_params(tm))
    return tm.to(dtype), jm, params


def _batch(seed=0, n=B, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, H, 1)).astype(dtype), rng.uniform(-1, 1, (n, 4)).astype(dtype))


def _jax_draws(key, x, n_steps=T, drop_prob=0.25):
    """The draws of the JAX package's ``GaussianDiffusion.loss(key)``, staged for the port."""
    k_t, k_noise, k_mask = jax.random.split(key, 3)
    b = x.shape[0]
    t = jax.random.randint(k_t, (b,), 0, n_steps)
    noise = jax.random.normal(k_noise, x.shape, x.dtype)
    mask = jax.random.bernoulli(k_mask, drop_prob, (b, 1))
    return {"t": torch.from_numpy(np.asarray(t).astype(np.int64)),
            "noise": torch.from_numpy(np.array(noise)),
            "mask": torch.from_numpy(np.asarray(mask).astype(np.asarray(x).dtype))}


def _flat(tree, layout, dtype=None):
    """A flax tree (params, mu, nu, EMA) as the port's flat buffer."""
    return layout.flatten(from_flax_params(jax.tree_util.tree_map(np.asarray, tree), dtype))


def _adam(opt_state):
    return opt_state[1][0]


def _noise_bias_mask(model, layout):
    """The flat elements whose gradient is analytically 0: biases of convs
    feeding a GroupNorm of one channel per group."""
    mask = torch.zeros(layout.numel, dtype=torch.bool)
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.GroupNorm) and mod.num_channels == mod.num_groups:
            conv_bias = name.rsplit(".", 1)[0] + ".0.bias"
            i = layout.names.index(conv_bias)
            mask[layout.offsets[i]:layout.offsets[i] + mod.num_channels] = True
    return mask


def _padding_mask(model, layout):
    taps = model.padding_taps()
    return layout.flatten({n: taps.get(n, torch.zeros(s, dtype=torch.bool))
                           for n, s in zip(layout.names, layout.shapes)})


def _jax_loss_fn(jd, jm):
    def loss_fn(params, x, c, draws):
        t, noise, mask = draws
        return JLOSSES["l2"](jm.apply(params, jd.q_sample(x, t, noise), t, c, mask), noise)
    return loss_fn


def _port_grads(tm, x, c, draws, dtype):
    """(loss, gradients by name) of the port's loss in ``dtype`` on staged draws."""
    d = GaussianDiffusion(make_schedule("exponential", T))
    leaves = {n: p.detach().to(dtype).clone().requires_grad_() for n, p in tm.named_parameters()}
    cast = lambda a: torch.as_tensor(a).to(dtype)
    loss = d.loss(lambda *a: torch.func.functional_call(tm, leaves, a), cast(x), cast(c),
                  draws["t"], cast(draws["noise"]), cast(draws["mask"]))
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def test_gradients_match_jax_leaf_by_leaf():
    """Autograd's gradient of the loss against JAX's on JAX's draws: in
    float64 leaf by leaf (1e-10 of the largest element); in float32 the
    loss within 1e-5 of JAX's and the gradient within 1e-5 (global,
    relative) of the port's float64 gradient on the same draws; the
    padding-only taps exactly 0 in every one. JAX's loss and gradient are
    those of the JAX package's first train step (``_jax_first_step``), so
    the file compiles no JAX function of its own for them."""
    key = jax.random.PRNGKey(4)
    with _x64():
        tm, _, _ = _models(dtype=torch.float64)
        x, c = _batch(dtype=np.float64)
        jloss, jgrad = _jax_first_step(True, x, c, key)
        loss, g = _port_grads(tm, x, c, _jax_draws(key, jnp.asarray(x)), torch.float64)
    layout = pt.ParamLayout.of(tm)
    pad = _padding_mask(tm, layout)
    jg = from_flax_params(jax.tree_util.tree_map(np.asarray, jgrad), dtype=None)
    assert set(jg) == set(g)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-12)
    scale = max(v.abs().max().item() for v in jg.values())
    for name in g:
        np.testing.assert_allclose(g[name].numpy() / scale, jg[name].numpy() / scale, rtol=0,
                                   atol=1e-10, err_msg=name)
    assert int(pad.sum()) > 0 and (layout.flatten(jg)[pad] == 0).all()
    assert (layout.flatten(g)[pad] == 0).all()

    tm, _, _ = _models()
    x, c = _batch()
    jloss, _ = _jax_first_step(False, x, c, key)
    draws = _jax_draws(key, jnp.asarray(x))
    loss, g32 = _port_grads(tm, x, c, draws, torch.float32)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    g32, g64 = (layout.flatten(_port_grads(tm, x, c, draws, torch.float64)[1]), layout.flatten(g32))[::-1]
    assert (g32[pad] == 0).all() and (g64[pad] == 0).all()
    assert ((g32.double() - g64).norm() / g64.norm()).item() < 1e-5


START_EMA, EVERY_EMA = 3, 2   # the EMA schedule of every JAX step below


@functools.lru_cache(maxsize=None)
def _jax_step(x64: bool):
    """The JAX package's jitted train step of the small model, one per
    precision, with the clip's threshold its first argument: the optimizer
    and the step are built inside the traced function (optax's
    ``clip_by_global_norm`` takes a traced threshold), so that one compile
    (~25-50 s on the CPU) serves every clip in the file. ``x64`` only keys
    the cache: the caller's precision decides what is traced."""
    jm = JaxUnet(**SMALL, conditioning_type="default", cfg_indicator=True)
    diffusion = JaxDiffusion(jax_schedule("exponential", T))

    def step(clip, state, x, c, key):
        opt = jt.make_optimizer(LR, clip)
        return jt.make_train_step(diffusion, jm.apply, opt, step_start_ema=START_EMA,
                                  update_ema_every=EVERY_EMA)(state, x, c, key)

    return jax.jit(step)


def _jax_state(params):
    """The JAX TrainState at the start: optax's state does not depend on the clip."""
    opt = jt.make_optimizer(LR)
    return jt.TrainState(params, jax.tree_util.tree_map(jnp.copy, params), opt.init(params),
                         jnp.int32(0))


def _jax_first_step(x64: bool, x, c, key):
    """The loss and the gradient (a flax tree) of the JAX package's first
    train step from ``_models()``' weights on ``(x, c)`` and ``key``, through
    the file's shared jitted step (``_jax_step``): in float64 with the clip
    at 1e6, which never engages, so that Adam's first moment over 1 - b1 is
    the gradient to the last bit or so (mu = (1 - b1) g from 0); in float32
    clipped at 1, of which only the loss is used."""
    _, _, params = _models(dtype=torch.float64 if x64 else torch.float32)
    state, met = _jax_step(x64)(1e6 if x64 else 1.0, _jax_state(params), jnp.asarray(x),
                                jnp.asarray(c), key)
    b1 = 0.9  # optax.adam's default, which jt.make_optimizer keeps
    grad = jax.tree_util.tree_map(lambda m: m / (1 - b1), _adam(state.opt_state).mu)
    return met["loss"], grad


def _start(x64: bool, clip: float = 1.0):
    """(port trainer, JAX step at ``clip``, JAX state) from the same initial weights."""
    tm, _, params = _models(dtype=torch.float64 if x64 else torch.float32)
    step = functools.partial(_jax_step(x64), clip)
    trainer = pt.Trainer(GaussianDiffusion(make_schedule("exponential", T)), tm, lr=LR,
                         clip_grad_max_norm=clip, step_start_ema=START_EMA,
                         update_ema_every=EVERY_EMA, device="cpu")
    return trainer, step, _jax_state(params)


def _state_errors(state, jstate, layout):
    """|port - JAX| / max |JAX| of the params, the EMA, mu and nu, elementwise."""
    adam = _adam(jstate.opt_state)
    out = {}
    for name, got, want in (("params", state.params, jstate.params),
                            ("ema", state.ema_params, jstate.ema_params),
                            ("mu", state.opt_state.mu, adam.mu), ("nu", state.opt_state.nu, adam.nu)):
        w = _flat(want, layout, None)
        out[name] = (got.double() - w.double()).abs() / w.abs().max().double()
    return out


def _assert_states_close(state, jstate, tol=1e-9):
    for name, err in _state_errors(state, jstate, state.layout).items():
        assert err.max().item() < tol, name


@pytest.mark.parametrize("clip", [1.0, 1e6], ids=["clip_engaged", "clip_off"])
def test_train_steps_match_jax(clip):
    """3 steps against make_train_step on JAX's draws, in float64: the
    params, Adam's mu, nu and count and the EMA within 1e-9 (relative to
    each buffer's largest value), the loss 1e-12; the padding-only taps
    exactly at their init on both sides. The clip engages at init (the
    first gradient's global norm is above 1) and never at 1e6."""
    with _x64():
        trainer, step, jstate = _start(True, clip)
        state = init = trainer.state
        for i in range(3):
            x, c = _batch(seed=i, dtype=np.float64)
            key = jax.random.PRNGKey(20 + i)
            if i == 0:
                g = _port_grads(trainer.model, x, c, _jax_draws(key, jnp.asarray(x)), torch.float64)[1]
                assert init.layout.flatten(g).norm().item() > 1.0
            jstate, jmet = step(jstate, jnp.asarray(x), jnp.asarray(c), key)
            state, met = trainer.train_step(state, torch.from_numpy(x), torch.from_numpy(c),
                                            _jax_draws(key, jnp.asarray(x)))
            assert not bool(met["update_skipped"]) and not bool(jmet["update_skipped"])
            np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-12)
    assert int(state.step) == int(state.opt_state.count) == int(_adam(jstate.opt_state).count) == 3
    _assert_states_close(state, jstate)
    pad = _padding_mask(trainer.model, init.layout)
    assert torch.equal(state.params[pad], init.params[pad])
    assert torch.equal(_flat(jstate.params, init.layout, None)[pad], init.params[pad])


def test_float32_train_step_matches_jax_but_near_zero_gradients():
    """One float32 step against JAX's: the loss 1e-5; params, mu, nu and the
    EMA within 1e-5 apart from the elements whose float64 gradient is below
    1e-5 but not 0, each of which moved by at most 2 lr: Adam's first update
    is lr g / (|g| + 1e-8), +-lr wherever |g| >> 1e-8, and float32's error
    in g (at most 3.4e-6 per element here) decides its sign there. They are
    counted (N_NEAR_ZERO), and include the 72 conv biases feeding a
    GroupNorm of one channel per group, whose gradient is 0 but for
    rounding. The padding-only taps stay exactly at their init."""
    trainer, step, jstate = _start(False)
    layout = trainer.state.layout
    x, c = _batch(seed=0)
    key = jax.random.PRNGKey(20)
    draws = _jax_draws(key, jnp.asarray(x))
    jstate, jmet = step(jstate, jnp.asarray(x), jnp.asarray(c), key)
    state, met = trainer.train_step(trainer.state, torch.from_numpy(x), torch.from_numpy(c), draws)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    g64 = layout.flatten(_port_grads(trainer.model, x, c, draws, torch.float64)[1])
    g32 = layout.flatten(_port_grads(trainer.model, x, c, draws, torch.float32)[1])
    assert (g32.double() - g64).abs().max().item() < 5e-6  # no sign flips above 1e-5
    near_zero = (g64.abs() < 1e-5) & (g64 != 0)
    noise_bias = _noise_bias_mask(trainer.model, layout)
    assert int(noise_bias.sum()) == 72 and bool(near_zero[noise_bias].all())
    assert int(near_zero.sum()) == N_NEAR_ZERO
    for name, err in _state_errors(state, jstate, layout).items():
        assert err[~near_zero].max().item() < 1e-5, name
    for got, want in ((state.params, jstate.params), (state.ema_params, jstate.ema_params)):
        assert (got - _flat(want, layout, None))[near_zero].abs().max().item() <= 2 * LR
    pad = _padding_mask(trainer.model, layout)
    assert torch.equal(state.params[pad], trainer.state.params[pad])


def test_nan_guard_matches_jax():
    """A batch with a NaN at step 2: the loss not finite; params, mu, nu
    and count stay, the step counter advances, the EMA (a hard copy before
    step 3) copies the kept params, update_skipped is set, as in JAX; the
    steps before and after update (float64, 1e-9)."""
    with _x64():
        trainer, step, jstate = _start(True)
        state, n_updates = trainer.state, 0
        for i, poison in enumerate((False, True, False)):
            x, c = _batch(seed=i, dtype=np.float64)
            if poison:
                x[3, 2, 0] = np.nan
            key = jax.random.PRNGKey(40 + i)
            before = state
            jstate, jmet = step(jstate, jnp.asarray(x), jnp.asarray(c), key)
            state, met = trainer.train_step(state, torch.from_numpy(x), torch.from_numpy(c),
                                            _jax_draws(key, jnp.asarray(x)))
            n_updates += not poison
            assert bool(met["update_skipped"]) == bool(jmet["update_skipped"]) == poison
            assert int(state.step) == int(jstate.step) == i + 1
            assert int(state.opt_state.count) == int(_adam(jstate.opt_state).count) == n_updates
            if poison:
                assert not np.isfinite(float(met["loss"]))
                for got, old in ((state.params, before.params), (state.opt_state.mu, before.opt_state.mu),
                                 (state.opt_state.nu, before.opt_state.nu)):
                    assert torch.equal(got, old)
                assert torch.equal(state.ema_params, before.params)
            _assert_states_close(state, jstate)


def test_ema_schedule_matches_jax():
    """step_start_ema 3 and every 2 over 8 steps: a hard copy at steps 1
    and 2, the EMA kept at the odd steps from 3, a decay towards the new
    params at steps 4, 6 and 8; equal to JAX's after every step (float64)."""
    with _x64():
        trainer, step, jstate = _start(True)
        state = trainer.state
        for i in range(8):
            x, c = _batch(seed=i, dtype=np.float64)
            key = jax.random.PRNGKey(60 + i)
            before = state
            jstate, _ = step(jstate, jnp.asarray(x), jnp.asarray(c), key)
            state, _ = trainer.train_step(state, torch.from_numpy(x), torch.from_numpy(c),
                                          _jax_draws(key, jnp.asarray(x)))
            n = i + 1
            if n < START_EMA:
                assert torch.equal(state.ema_params, state.params)
            elif n % EVERY_EMA:
                assert torch.equal(state.ema_params, before.ema_params)
            else:
                assert torch.equal(state.ema_params,
                                   before.ema_params * 0.995 + state.params * (1.0 - 0.995))
            _assert_states_close(state, jstate)


def test_chunk_matches_loop_and_jax_chunk_draws():
    """A chunk of 4 steps on staged indices and draws equals the per-step
    loop exactly, its mean and per-step losses included. Staged with the
    draws that JAX's make_scanned_train_steps derives from its key (per
    inner step the indices, then the loss's keys), it follows JAX's train
    step on them (float64, 1e-9). Drawn from a generator, a replay of the
    same seed gives the same state."""
    n_inner, n = 4, 64
    with _x64():
        trainer, step, jstate = _start(True)
        x_all, c_all = _batch(seed=5, n=n, dtype=np.float64)
        staged = {"idx": [], "t": [], "noise": [], "mask": []}
        for k in jax.random.split(jax.random.PRNGKey(7), n_inner):
            k_idx, k_loss = jax.random.split(k)
            idx = np.asarray(jax.random.randint(k_idx, (B,), 0, n)).astype(np.int64)
            jstate, _ = step(jstate, jnp.asarray(x_all[idx]), jnp.asarray(c_all[idx]), k_loss)
            staged["idx"].append(torch.from_numpy(idx))
            for name, v in _jax_draws(k_loss, jnp.asarray(x_all[idx])).items():
                staged[name].append(v)
        staged = {k: torch.stack(v) for k, v in staged.items()}
        xs, cs = torch.from_numpy(x_all), torch.from_numpy(c_all)
        chunk = pt.make_scanned_train_steps(trainer.train_step, n_inner)
        state_c, losses = chunk(trainer.state, xs, cs, B, staged, per_step=True)
        _, mean = chunk(trainer.state, xs, cs, B, staged)
        state_l, loop_losses = trainer.state, []
        for i in range(n_inner):
            idx = staged["idx"][i]
            state_l, met = trainer.train_step(state_l, xs[idx], cs[idx],
                                              {k: staged[k][i] for k in ("t", "noise", "mask")})
            loop_losses.append(met["loss"])
    assert torch.equal(state_c.params, state_l.params) and torch.equal(losses, torch.stack(loop_losses))
    assert torch.equal(state_c.ema_params, state_l.ema_params) and int(state_c.step) == n_inner
    assert float(mean) == float(losses.mean())
    _assert_states_close(state_c, jstate)
    g = lambda: torch.Generator().manual_seed(3)
    s1, l1 = chunk(trainer.state, xs, cs, B, g(), per_step=True)
    s2, l2 = chunk(trainer.state, xs, cs, B, g(), per_step=True)
    assert torch.equal(s1.params, s2.params) and torch.equal(l1, l2) and l1.shape == (n_inner,)


def test_checkpoint_resume_and_jax_checkpoint(tmp_path):
    """The port: 6 steps equal 3 + save + load + 3, every buffer exact, the
    payload in the JAX layout. A checkpoint that the JAX package writes after
    3 steps loads in the port (optax's classes mapped without optax) and 3
    more steps follow JAX's own 3 more (float64, 1e-9)."""
    batches = [_batch(seed=i, dtype=np.float64) for i in range(6)]
    keys = [jax.random.PRNGKey(80 + i) for i in range(6)]
    with _x64():
        trainer, step, jstate = _start(True)
        draws = [_jax_draws(k, jnp.asarray(x)) for k, (x, _) in zip(keys, batches)]
        for i in range(6):
            jstate, _ = step(jstate, *map(jnp.asarray, batches[i]), keys[i])
            if i == 2:
                jt.save_checkpoint(str(tmp_path / "jax.ckpt"), jstate, extra={"by": "jax"})

    def run(state, steps):
        with _x64():
            for i in steps:
                state, _ = trainer.train_step(state, *map(torch.from_numpy, batches[i]), draws[i])
        return state

    straight = run(trainer.state, range(6))
    half = run(trainer.state, range(3))
    pt.save_checkpoint(str(tmp_path / "port.ckpt"), half, extra={"note": 1})
    with open(tmp_path / "port.ckpt", "rb") as f:
        payload = pickle.load(f)
    assert set(payload) == {"params", "ema_params", "opt_state", "step", "extra"}
    assert payload["step"] == 3 and payload["extra"] == {"note": 1}
    assert jax.tree_util.tree_structure(payload["params"]) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    assert int(payload["opt_state"][1][0].count) == 3
    loaded, extra = pt.load_checkpoint(str(tmp_path / "port.ckpt"), half.layout, "cpu")
    assert extra == {"note": 1} and int(loaded.step) == 3
    resumed = run(loaded, range(3, 6))
    for a, b in ((resumed.params, straight.params), (resumed.ema_params, straight.ema_params),
                 (resumed.opt_state.mu, straight.opt_state.mu),
                 (resumed.opt_state.nu, straight.opt_state.nu)):
        assert torch.equal(a, b)
    assert int(resumed.step) == 6 and int(resumed.opt_state.count) == 6

    from_jax, extra = pt.load_checkpoint(str(tmp_path / "jax.ckpt"), half.layout, "cpu")
    assert extra == {"by": "jax"} and int(from_jax.step) == 3 and from_jax.params.dtype == torch.float64
    assert ((from_jax.params - half.params).abs().max() / half.params.abs().max()).item() < 1e-9
    cont = run(from_jax, range(3, 6))
    assert int(cont.step) == 6
    _assert_states_close(cont, jstate)


def test_to_flax_params_round_trip_and_jax_forward_on_port_weights():
    """to_flax_params inverts from_flax_params exactly (the transposed
    conv's flip included) on the LMPC architecture, and the JAX model's
    output on weights the port trained equals the port's (1e-5)."""
    tm = init_like_flax(TemporalUnet(**LMPC_CONFIG, cfg_indicator=True), np.random.RandomState(3))
    flax = to_flax_params(tm)
    back = from_flax_params(flax)
    for name, p in tm.named_parameters():
        assert torch.equal(back[name], p.detach()), name
    again = to_flax_params(back)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, flax, again))
    up = flax["params"]["Upsample1d_0"]["ConvTranspose_0"]["kernel"]
    np.testing.assert_array_equal(up[::-1].transpose(1, 2, 0), tm.ups[0][4].conv.weight.detach().numpy())

    small, jm, _ = _models()
    trainer = pt.Trainer(GaussianDiffusion(make_schedule("exponential", T)), small, lr=LR, device="cpu")
    x, c = _batch(seed=9)
    state = trainer.state
    for i in range(3):
        state, _ = trainer.train_step(state, torch.from_numpy(x), torch.from_numpy(c),
                                      torch.Generator().manual_seed(i))
    trained = TemporalUnet(**SMALL, cfg_indicator=True)
    trained.load_state_dict(state.layout.views(state.params))
    params = jax.tree_util.tree_map(jnp.asarray, to_flax_params(trained))
    t = np.arange(B) % T
    mask = (np.arange(B) % 3 == 0).astype(np.float32)[:, None]
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c), jnp.asarray(mask))
    with torch.no_grad():
        got = trained(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c),
                      torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_init_like_flax_matches_flax_init_statistics():
    """Per leaf over 512 draws each (at least 4,096 values): the std of every kernel within 5% of
    flax's init's and of sqrt(1 / fan_in); no draw beyond 2 sigma (sigma =
    sqrt(1 / fan_in) / 0.8796); biases exactly 0, GroupNorm scales exactly
    1; the numpy and torch generators both; the same seed the same weights."""
    n_draws = 512
    jm = JaxUnet(**SMALL, conditioning_type="default", cfg_indicator=True)
    init = jax.jit(jax.vmap(lambda k: jm.init(k, jnp.zeros((2, H, 1)), jnp.zeros((2,), jnp.int32),
                                              jnp.zeros((2, 4)), jnp.zeros((2, 1)))))
    # flax's initializers on keys of XLA's RngBitGenerator: the same distributions as on
    # threefry keys, and the vmapped init compiles in a third of the time
    keys = jax.random.split(jax.random.key(0, impl="rbg"), n_draws)
    flax_draws = jax.tree_util.tree_map(np.asarray, init(keys))
    rs, gen = np.random.RandomState(5), torch.Generator().manual_seed(5)
    model = TemporalUnet(**SMALL, cfg_indicator=True)
    ports = [to_flax_params(init_like_flax(model, rs if i % 2 else gen)) for i in range(n_draws)]
    paths = jax.tree_util.tree_leaves_with_path(flax_draws)
    n_kernels = 0
    for path, leaf in paths:
        name = jax.tree_util.keystr(path)
        port = np.stack([_leaf(p, path) for p in ports])
        assert port.shape == leaf.shape, name
        last = path[-1].key
        if last == "kernel":
            n_kernels += 1
            fan_in = int(np.prod(leaf.shape[1:-1]))
            sigma = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert np.abs(port).max() <= 2 * sigma * (1 + 1e-6), name
            assert abs(port.std() / leaf.std() - 1) < 0.05, name
            assert abs(port.std() / np.sqrt(1.0 / fan_in) - 1) < 0.05, name
        elif last == "scale":
            assert (port == 1).all() and (leaf == 1).all(), name
        else:
            assert (port == 0).all() and (leaf == 0).all(), name
    assert n_kernels == sum(1 for p, _ in paths if p[-1].key == "kernel") > 30
    a = init_like_flax(TemporalUnet(**SMALL), np.random.RandomState(2))
    b = init_like_flax(TemporalUnet(**SMALL), np.random.RandomState(2))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_trainer_fit_per_step_and_chunked(tmp_path):
    """Trainer.fit replays its generator's draws: per step, the batch's
    indices then the loss draws; chunked, make_scanned_train_steps' order.
    It logs at the first step and every steps_til_summary (the chunk's
    mean when chunked), calls summary_fn with the step on the EMA weights,
    validates, checkpoints (the tagged step, current and final, and the
    loss .npy files), resumes, and stops early as the JAX EarlyStopper does."""
    d = GaussianDiffusion(make_schedule("exponential", T))
    x, c = _batch(seed=11, n=80)
    ds = ControlSequenceDataset.from_arrays(x, c, device="cpu")
    tm, _, _ = _models()
    trainer = pt.Trainer(d, tm, lr=LR, checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    init = trainer.state
    logs, summaries = [], []
    summary = lambda ema, gen, step: summaries.append((step, ema["final_conv.1.bias"].clone())) or {"s": step}
    state = trainer.fit(ds, 6, batch_size=16, generator=torch.Generator().manual_seed(1),
                        steps_til_summary=4, steps_til_checkpoint=5, log_fn=logs.append,
                        summary_fn=summary, val_dataset=ds, steps_per_validation=2)
    gen, want = torch.Generator().manual_seed(1), init
    for _ in range(6):
        inputs, cond = ds.batch(gen, 16)
        want, _ = trainer.train_step(want, inputs, cond, gen)
        if int(want.step) in (1, 4):  # the validation's 2 batches and their loss draws
            for _ in range(2):
                ds.batch(gen, 16)
                d.loss(lambda x, *a: torch.zeros_like(x), torch.zeros(16, H, 1),
                       torch.zeros(16, 4), generator=gen)
    assert torch.equal(state.params, want.params) and int(state.step) == 6
    assert [s for s, _ in trainer.train_losses] == [1, 4] and [s for s, _ in trainer.val_losses] == [1, 4]
    assert [s for s, _ in summaries] == [1, 4] and len(logs) == 2 and "step 4/6" in logs[1]
    files = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert files == ["current.ckpt", "final.ckpt", "step_000005.ckpt", "train_losses.npy",
                     "val_losses.npy"]
    np.testing.assert_array_equal(np.load(tmp_path / "ck" / "train_losses.npy")[:, 0], [1, 4])

    chunked = pt.Trainer(d, _models()[0], lr=LR, device="cpu")
    logs = []
    chunked.fit(ds, 8, batch_size=16, generator=torch.Generator().manual_seed(2),
                steps_til_summary=4, chunk_size=4, log_fn=logs.append)
    chunk = pt.make_scanned_train_steps(chunked.train_step, 4)
    gen, want, means = torch.Generator().manual_seed(2), init, []
    for _ in range(2):
        want, m = chunk(want, ds.inputs_normalized, ds.condition_normalized, 16, gen)
        means.append(float(m))
    assert torch.equal(chunked.state.params, want.params)
    assert chunked.train_losses == [(4, means[0]), (8, means[1])] and len(logs) == 2

    resumed = pt.Trainer(d, _models()[0], lr=LR, device="cpu")
    resumed.resume(str(tmp_path / "ck" / "step_000005.ckpt"))
    assert int(resumed.state.step) == 5
    resumed.fit(ds, 5, batch_size=16, log_fn=logs.append)  # already there: no step
    assert int(resumed.state.step) == 5

    stopper, jstopper = pt.EarlyStopper(2, 0.01), jt.EarlyStopper(2, 0.01)
    for v in (1.0, 0.5, 0.52, 0.515, 0.6, 0.4, 0.7, 0.7):
        assert stopper.early_stop(v) == jstopper.early_stop(v)
    assert not pt.EarlyStopper().early_stop(1e9)


def test_flagship_lmpc_script_end_to_end(tmp_path):
    """The recipe at toy size on the CPU: a dataset in the JAX .npz keys,
    the JAX checkpoint payload, and an EMA pickle that the JAX package's
    model applies to the port's output (1e-5) and load_lmpc reads."""
    out = tmp_path / "run"
    report = flagship_lmpc.main(["--device", "cpu", "--out", str(out), "--train-steps", "4",
                                 "--chunk", "2", "--batch-size", "16", "--grid", "3", "--noisy",
                                 "2", "--track-steps", "2", "--track-noisy", "1", "--states", "2",
                                 "--eval-steps", "3", "--log-every", "2"])
    n = 9 * 3 + 9 * 2 * 2
    assert report["n_samples"] == n and report["train_steps"] == 4 and np.isfinite(report["final_loss"])
    assert len(report["per_state_u_l1"]) == 2 and report["launches"] == 0
    jds = JaxDataset.load(str(out / "dataset.npz"))
    assert jds.n_init == n
    with open(out / "ema_params.pkl", "rb") as f:
        pkl = pickle.load(f)
    assert pkl["step"] == 4 and pkl["cfg_indicator"] is True and pkl["horizon"] == H
    jm = JaxUnet(**{**LMPC_CONFIG, "n_support_points": H}, conditioning_type="default",
                 cfg_indicator=True)
    tm = load_lmpc(out / "ema_params.pkl", device="cpu")
    x, c = _batch(seed=12, n=4)
    t = np.array([0, 5, 17, 24])
    mask = np.array([[0.0], [1.0], [0.0], [1.0]], np.float32)
    want = jm.apply(pkl["ema_params"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(c), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    layout = pt.ParamLayout.of(tm)
    ck, _ = pt.load_checkpoint(str(out / "checkpoints" / "final.ckpt"), layout, "cpu")
    assert int(ck.step) == 4
    assert torch.equal(ck.ema_params, layout.flatten(dict(tm.named_parameters())))


def _recipe_arrays_jax():
    """The port recipe's step 1 through the JAX package's LQR solver and plant."""
    mats = linear_matrices(cartpole_lmpc(), cartpole_lmpc_cost())
    ja, jb, jq, jr, jp = (jnp.asarray(m.numpy()) for m in mats)
    grid = flagship_lmpc.recipe_grid()
    noise = np.random.RandomState(0).standard_normal((399,) + grid.shape).astype(np.float32)
    x_grid = np.concatenate([grid, (grid[None] + noise * np.float32(0.15)).reshape(-1, 4)])
    solve = jax.jit(lambda xx: jax_lqr.lqr_solve_batched(ja, jb, jq, jr, jp, xx, H).us)
    jplant = jax_cp.cartpole_lmpc()

    def expert_track(x0):
        def body(xx, _):
            sol = jax_lqr.lqr_solve(ja, jb, jq, jr, jp, xx, H)
            return jplant.step(xx, sol.us[0]), (xx, sol.us)
        return jax.lax.scan(body, x0, None, length=50)[1]

    xs, us = jax.jit(jax.vmap(expert_track))(jnp.asarray(grid))
    x_cl, u_cl = np.asarray(xs).reshape(-1, 4), np.asarray(us).reshape(-1, H, 1)
    tn = np.random.RandomState(1).normal(0, 0.15, (4,) + x_cl.shape)
    x_noisy = (x_cl[None] + tn).reshape(-1, 4).astype(np.float32)
    u_all = np.concatenate([np.asarray(solve(jnp.asarray(x_grid))), u_cl,
                            np.asarray(solve(jnp.asarray(x_noisy)))])
    return u_all, np.concatenate([x_grid, x_cl, x_noisy])


def jax_yardstick():
    """Every literal of data/lmpc_train_yardstick.py, by the JAX package on the CPU."""
    ds = JaxDataset.from_arrays(*_recipe_arrays_jax())
    tm = init_like_flax(TemporalUnet(**LMPC_CONFIG, cfg_indicator=True),
                        np.random.RandomState(ys.INIT_SEED))
    params = jax.tree_util.tree_map(jnp.asarray, to_flax_params(tm))
    jm = JaxUnet(**LMPC_CONFIG, conditioning_type="default", cfg_indicator=True)
    opt = jt.make_optimizer(3e-3)
    step = jax.jit(jt.make_custom_train_step(
        _jax_loss_fn(JaxDiffusion(jax_schedule("exponential", T)), jm), opt))
    state = jt.TrainState(params, jax.tree_util.tree_map(jnp.copy, params), opt.init(params),
                          jnp.int32(0))
    draws = ys.staged_draws(ds.n_init)
    losses = []
    for i in range(ys.N_STEPS):
        idx = jnp.asarray(draws["idx"][i])
        state, met = step(state, ds.inputs_normalized[idx], ds.condition_normalized[idx],
                          (jnp.asarray(draws["t"][i]), jnp.asarray(draws["noise"][i]),
                           jnp.asarray(draws["mask"][i])))
        losses.append(float(met["loss"]))
    st = {f: ds.normalizer.stats[f] for f in ("inputs", "condition")}
    return {"INPUTS_MINS": np.asarray(st["inputs"].mins).tolist(),
            "INPUTS_MAXS": np.asarray(st["inputs"].maxs).tolist(),
            "CONDITION_MINS": np.asarray(st["condition"].mins).tolist(),
            "CONDITION_MAXS": np.asarray(st["condition"].maxs).tolist(),
            "INIT_CHECKSUM": list(ys.checksum(list(tm.parameters()))),
            "LOSSES": losses, "N_SAMPLES": ds.n_init}


@pytest.mark.slow
def test_yardstick_regenerates():
    """The JAX package recomputes data/lmpc_train_yardstick.py: the limits
    and the checksum exactly, each loss within 1e-6 (XLA's CPU code)."""
    got = jax_yardstick()
    assert got["N_SAMPLES"] == ys.N_SAMPLES
    for name in ("INPUTS_MINS", "INPUTS_MAXS", "CONDITION_MINS", "CONDITION_MAXS", "INIT_CHECKSUM"):
        assert tuple(got[name]) == getattr(ys, name), name
    np.testing.assert_allclose(got["LOSSES"], ys.LOSSES, rtol=1e-6)


def test_port_on_cpu_follows_the_yardstick():
    """The port's recipe dataset on the CPU has the yardstick's limits
    (rtol 1e-5), its initial weights the yardstick's checksum exactly, and
    its first 2 train steps at full width the yardstick's losses (rtol 1e-4)."""
    ds = flagship_lmpc.collect_recipe_dataset("cpu")
    assert ds.n_init == ys.N_SAMPLES
    for field, mins, maxs in (("inputs", ys.INPUTS_MINS, ys.INPUTS_MAXS),
                              ("condition", ys.CONDITION_MINS, ys.CONDITION_MAXS)):
        stats = ds.normalizer.stats[field]
        np.testing.assert_allclose(stats.mins.numpy(), mins, rtol=1e-5)
        np.testing.assert_allclose(stats.maxs.numpy(), maxs, rtol=1e-5)
    model = flagship_lmpc.lmpc_model("cpu")
    assert ys.checksum(list(model.parameters())) == ys.INIT_CHECKSUM
    trainer = pt.Trainer(GaussianDiffusion(make_schedule("exponential", T)), model, lr=3e-3,
                         device="cpu")
    n = 2
    draws = {k: torch.from_numpy(v[:n]) for k, v in ys.staged_draws(ds.n_init, n_steps=n).items()}
    chunk = pt.make_scanned_train_steps(trainer.train_step, n)
    _, losses = chunk(trainer.state, ds.inputs_normalized, ds.condition_normalized, ys.BATCH, draws,
                      per_step=True)
    np.testing.assert_allclose(losses.numpy(), ys.LOSSES[:n], rtol=1e-4)


@pytest.mark.gpu
def test_train_step_on_the_card_matches_cpu():
    """One train step on the card against the same step on the CPU (full
    width, batch 64): loss 1e-5, the updated params within 2 lr where Adam's
    sign may flip and the padding-only taps exactly at their init."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step runs on cuDNN's kernels there")
    model = flagship_lmpc.lmpc_model("cpu")
    d = GaussianDiffusion(make_schedule("exponential", T))
    draws = {k: torch.from_numpy(v[0]) for k, v in ys.staged_draws(1000, 1, 64).items()}
    x, c = _batch(seed=13, n=1000)
    out = {}
    for dev in ("cpu", "cuda"):
        m = TemporalUnet(**LMPC_CONFIG, cfg_indicator=True)
        m.load_state_dict(model.state_dict())
        trainer = pt.Trainer(d, m, lr=3e-3, device=dev)
        idx = draws["idx"].to(dev)
        state, met = trainer.train_step(trainer.state, torch.from_numpy(x).to(dev)[idx],
                                        torch.from_numpy(c).to(dev)[idx],
                                        {k: draws[k].to(dev) for k in ("t", "noise", "mask")})
        out[dev] = (float(met["loss"]), state.params.cpu(), trainer.state.params.cpu())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    assert (out["cuda"][1] - out["cpu"][1]).abs().max().item() <= 2 * 3e-3 * (1 + 1e-6)
    pad = _padding_mask(model, pt.ParamLayout.of(model))
    assert torch.equal(out["cuda"][1][pad], out["cuda"][2][pad])


def test_train_divergence_and_profile_scripts_run_on_cpu():
    """The two measuring scripts at toy depth: train_divergence's unperturbed
    run follows the yardstick's first 2 steps (rtol 1e-4) and a one-ulp
    perturbation moves them by less; train_profile times and traces a step."""
    out = train_divergence.main(["--device", "cpu", "--steps", "2", "--perturbed", "1"])
    base, moved = out["runs"]
    assert base["perturbed_seed"] is None and base["vs_yardstick"]["max_1_2"] < 1e-4
    assert moved["perturbed_seed"] == 100 and moved["vs_unperturbed"]["max_1_2"] < 1e-4
    prof = train_profile.main(["--device", "cpu", "--batch", "8", "--steps", "2", "--profiled", "1"])
    assert prof["steps_per_s"] > 0 and prof["aten_calls_per_step"] > 100
    assert prof["kernels_per_step"] == 0 and prof["device_idle_share"] is None
