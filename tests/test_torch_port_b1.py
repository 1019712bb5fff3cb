"""The options of the JAX kernel builders that the port's kernels refused
until ROADMAP.md's B1 was ported, against the JAX package on the CPU (its
Pallas kernels in interpret mode, on small models):

- ``weights_dtype=jnp.bfloat16`` in the U-Net pass (kernel 2), the DDIM
  chain (kernel 4) and the DDIM episode (kernel 5). The U-Net pass runs its
  final 1x1 conv outside its kernel in fp32 on an unrounded y
  (mpc_via_diffusion_model_tpu/ops/fused_unet.py:450); the chain and the
  episode run it inside in bf16 on a rounded y (fused_denoise.py:213,
  fused_episode.py:339). Each is held off the other's choice.
- ``clip_denoised=False`` in the CFG chain and episode and the DDIM chain
  and episode (kernels 1, 3, 4 and 5): each test shows that the clip binds
  on its inputs (the clipped function differs from the unclipped one).
- The numpy emulations of the kernels' programs (``torch_port_util``) with
  the bf16 reads and the clip flag, against the plain versions.

Tolerances. bf16: a correct pair of versions agrees but where an activation
lies within an fp32 sum's rounding of a midpoint between two bf16 numbers
and rounds one way on one side and the other way on the other; such a flip
moves a small U-Net's pass by up to 7e-3 (tests/test_torch_port_bf16.py).
So the bf16 checks hold the median elementwise gap (TOL_MEDIAN) and the
largest (TOL_BF16), and require the known-wrong function to lie at least
WRONG_FACTOR times farther in the median. Without the clip there is no
rounding to flip: the port is held to JAX at TOL, relative to the largest
magnitude where that passes 1 (an unclipped CFG chain's first step, sra =
srm ~ 1e3 at T = 10, leaves x far outside [-1, 1]).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu.ops.fused_denoise import make_fused_cfg_chain as jax_cfg_chain
from mpc_via_diffusion_model_tpu.ops.fused_denoise import make_fused_ddim_chain as jax_ddim_chain
from mpc_via_diffusion_model_tpu.ops.fused_episode import make_fused_cfg_episode as jax_cfg_episode
from mpc_via_diffusion_model_tpu.ops.fused_episode import make_fused_ddim_episode as jax_ddim_episode
from mpc_via_diffusion_model_tpu.ops.fused_unet import make_fused_unet as jax_fused_unet
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import NormalizerStats
from mpc_via_diffusion_model_tpu_torch.diffusion.distillation import make_student_ddim_sampler
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_collect_cost,
                                                        cartpole_virtual_cost,
                                                        cartpole_virtual_swingup,
                                                        theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.models import TemporalUnet, from_flax_params
from mpc_via_diffusion_model_tpu_torch.models.bf16 import bf16_conv_copy
from mpc_via_diffusion_model_tpu_torch.ops import unet_pack as up
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import (make_fused_cfg_chain,
                                                                 make_fused_ddim_chain)
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import (make_fused_cfg_episode,
                                                                 make_fused_ddim_episode)
from mpc_via_diffusion_model_tpu_torch.ops.fused_unet import make_fused_unet
from torch_port_util import (emulate_cfg_chain_kernel, emulate_cfg_chain_turns_kernel,
                             emulate_cfg_episode_kernel, emulate_ddim_chain_kernel,
                             emulate_ddim_episode_kernel, emulate_fused_unet_kernel, randomize,
                             small_models)

torch.set_num_threads(1)

H, T, N_TAIL, W, N_STEPS = 8, 10, 2, 0.3, 2
TIMES = [9, 5, 1]
# the bf16 checks' grid: near t = 0 (sra ~ 1, srm small) a random model's reconstructions mostly
# stay inside [-1, 1], where the output carries eps; on TIMES they are clipped to +-1
TIMES_BF16 = [2, 0]
N_STEPS_DDIM = 6  # the DDIM episodes without the clip: enough replans for a clip to move a control
T_EMU, TIMES_EMU = 4, [3, 1]  # the emulated programs' schedule (numpy runs each pass layer by layer)
N_STEPS_EMU = 2  # the emulated DDIM episode's replans without the clip
TOL = 1e-4                       # clip off, the port's plain versions against JAX's kernels
TOL_MEDIAN, TOL_BF16, WRONG_FACTOR = 1e-5, 1e-2, 10.0
TOL_EMULATOR = 1e-3              # the emulated programs against the plain versions (a flip: 1.5e-4)
X0 = np.array([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], np.float32)
BF16 = torch.bfloat16


def _models(dim_mults):
    """(jax model, flax params, torch model) at horizon 8, widths 8 x dim_mults, context 5."""
    cfg = dict(state_dim=1, n_support_points=H, unet_input_dim=8, dim_mults=dim_mults,
               context_dim=5, cfg_indicator=True)
    jm = JaxUnet(conditioning_type="default", **cfg)
    params = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, H, 1)),
                                      jnp.zeros((1,), jnp.int32), jnp.zeros((1, 5)),
                                      jnp.zeros((1, 1))), 41)
    tm = TemporalUnet(**cfg)
    tm.load_state_dict(from_flax_params(params))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def models():
    """One level of width 8: each JAX build in interpret mode compiles in about half the time
    of two levels'."""
    return _models((1,))


@pytest.fixture(scope="module")
def models_two_levels():
    """Widths 8/16: where the bf16 DDIM chain's final 1x1 conv left fp32 moves the output by
    more than WRONG_FACTOR times the right function's gap (at one level it moves it by less)."""
    return _models((1, 2))


@pytest.fixture(scope="module")
def cluster_models():
    """Small models whose convs and GroupNorms the cluster split accepts."""
    return small_models(seed=24)


def _stats(lib):
    if lib == "jax":
        return (JaxStats("limits", jnp.full((1,), -30.0), jnp.full((1,), 30.0)),
                JaxStats("limits", jnp.full((5,), -10.0), jnp.full((5,), 10.0)))
    return (NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0)),
            NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0)))


def _bf16_close(got, want, wrong, name):
    """The bf16 comparison: median and largest gap to the right function, and the known-wrong
    function at least WRONG_FACTOR times farther in the median."""
    got, want, wrong = (np.asarray(a, np.float64) for a in (got, want, wrong))
    right_med = float(np.median(np.abs(got - want)))
    wrong_med = float(np.median(np.abs(wrong - want)))
    assert right_med <= TOL_MEDIAN, (name, right_med)
    assert float(np.abs(got - want).max()) <= TOL_BF16, name
    assert wrong_med > WRONG_FACTOR * max(right_med, 1e-7), (name, right_med, wrong_med)


# --------------------------------------------------------------------------- bf16 against JAX

def test_unet_pass_bf16_matches_jax_with_its_final_1x1_in_fp32(models):
    """The port's plain bf16 U-Net pass (``make_fused_unet(weights_dtype=bf16)``: the backbone
    of ``bf16_conv_copy(model, round_final_1x1=False)``, the final 1x1 conv fp32 on an
    unrounded y) against JAX's builder in interpret mode; the all-rounded U-Net, the DDIM
    kernels' function, is the known-wrong one here."""
    jm, params, tm = models
    rs = np.random.RandomState(1)
    x = rs.standard_normal((4, H, 1)).astype(np.float32)
    t = np.array([9, 5, 1, 0], np.int32)
    ctx = rs.uniform(-1, 1, (4, 5)).astype(np.float32)
    mask = np.array([[0.0], [1.0], [0.0], [1.0]], np.float32)
    want = jax_fused_unet(jm, params, 4, interpret=True, weights_dtype=jnp.bfloat16)(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(mask))
    unet = make_fused_unet(tm, 4, weights_dtype=BF16, device="cpu")
    assert unet.entry == "fused_unet_bf16"
    args = [torch.from_numpy(a) for a in (x, t.astype(np.int64), ctx, mask)]
    got = unet(*args)
    assert (unet.launches, unet.plain_calls) == (0, 1)
    with torch.no_grad():
        wrong = bf16_conv_copy(tm)(*args)
    _bf16_close(got.numpy(), want, wrong.numpy(), "fused_unet_bf16")


def test_ddim_chain_bf16_matches_jax(models_two_levels):
    """The port's plain bf16 DDIM chain against JAX's builder in interpret mode, on the draw JAX
    makes from its key; its final 1x1 conv rounded as JAX's (the final 1x1 left fp32 is the
    known-wrong function)."""
    jm, params, tm = models_two_levels
    key = jax.random.PRNGKey(3)
    ctx = np.random.RandomState(2).uniform(-1, 1, (2, 5)).astype(np.float32)
    want = jax_ddim_chain(jm, params, jax_make_schedule("exponential", T), TIMES_BF16, n_samples=2,
                          weights_dtype=jnp.bfloat16, interpret=True)(jnp.asarray(ctx), key)
    x_init = torch.from_numpy(np.array(jax.random.normal(key, (2, H, 1), jnp.float32)))
    sched = make_schedule("exponential", T)
    chain = make_fused_ddim_chain(tm, sched, TIMES_BF16, 2, weights_dtype=BF16, device="cpu")
    got = chain(torch.from_numpy(ctx), x_init)
    wrong = make_student_ddim_sampler(sched, bf16_conv_copy(tm, round_final_1x1=False), TIMES_BF16)(
        torch.from_numpy(ctx), x_init)
    _bf16_close(got.numpy(), want, wrong.numpy(), "ddim_chain_bf16")


def _jax_ddim_noise(key, n_steps=N_STEPS):
    return np.stack([np.array(jax.random.normal(kk, (1, H, 1), jnp.float32))
                     for kk in jax.random.split(key, n_steps)])


def test_ddim_episode_bf16_matches_jax(models):
    """The port's plain bf16 DDIM episode (``ddim_episode_bf16``) against JAX's builder with
    ``weights_dtype=jnp.bfloat16`` in interpret mode (the JAX package's own test runs it in
    tests/test_fused_episode.py:98-113), on JAX's draws; the controls in normalized units."""
    jm, params, tm = models
    key = jax.random.PRNGKey(5)
    ins, cs = _stats("jax")
    want = jax_ddim_episode(jm, params, jax_make_schedule("exponential", T), TIMES_BF16, ins, cs,
                            jax_cp.cartpole_virtual_swingup(),
                            jax_cp.cartpole_virtual_collect_cost(), n_steps=N_STEPS,
                            weights_dtype=jnp.bfloat16, interpret=True)(jnp.asarray(X0), key)
    ins, cs = _stats("torch")
    ep_of = lambda model, wd: make_fused_ddim_episode(
        model, make_schedule("exponential", T), TIMES_BF16, ins, cs, cartpole_virtual_swingup(),
        cartpole_virtual_collect_cost(), n_steps=N_STEPS, weights_dtype=wd, device="cpu")
    ep = ep_of(tm, BF16)
    assert ep.name == "ddim_episode_bf16"
    noise = torch.from_numpy(_jax_ddim_noise(key))
    got = ep(torch.from_numpy(X0), noise)
    wrong = ep_of(bf16_conv_copy(tm, round_final_1x1=False), torch.float32)(
        torch.from_numpy(X0), noise)
    _bf16_close(got[1].numpy() / 30.0, np.asarray(want[1]) / 30.0, wrong[1].numpy() / 30.0,
                "ddim_episode_bf16 u_track")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL_BF16, atol=TOL_BF16)


def test_bf16_conv_copy_leaves_the_final_1x1_conv_when_asked(models):
    """``bf16_conv_copy(model, round_final_1x1=False)`` rounds every conv but the final 1x1,
    which keeps its fp32 weights and no input hook; the default rounds it too."""
    tm = models[2]
    keep, full = bf16_conv_copy(tm, round_final_1x1=False), bf16_conv_copy(tm)
    assert torch.equal(keep.final_conv[1].weight, tm.final_conv[1].weight)
    assert not keep.final_conv[1]._forward_pre_hooks and full.final_conv[1]._forward_pre_hooks
    assert not torch.equal(full.final_conv[1].weight, tm.final_conv[1].weight)
    assert torch.equal(keep.final_conv[0].block[0].weight, full.final_conv[0].block[0].weight)


# --------------------------------------------------------------------------- clip_denoised=False

def _rel_close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("builder", ["cfg_chain", "cfg_episode", "ddim_chain", "ddim_episode"])
def test_clip_off_matches_jax(models, builder):
    """``clip_denoised=False`` in each builder: the port's plain version against JAX's kernel in
    interpret mode on JAX's draws (TOL, relative to the largest magnitude past 1); the clipped
    plain version differs, so the clip binds on these inputs."""
    jm, params, tm = models
    jsched, sched = jax_make_schedule("exponential", T), make_schedule("exponential", T)
    key = jax.random.PRNGKey(7)
    ctx = np.random.RandomState(4).uniform(-1, 1, (2, 5)).astype(np.float32)
    jins, jcs = _stats("jax")
    ins, cs = _stats("torch")
    x0 = torch.from_numpy(X0)
    if builder == "cfg_chain":
        want = jax_cfg_chain(jm, params, jsched, n_samples=2, w=W,
                             n_diffusion_steps_without_noise=N_TAIL, clip_denoised=False,
                             interpret=True)(jnp.asarray(ctx), key)
        noise = torch.from_numpy(np.array(jax.random.normal(key, (T + N_TAIL + 1, 2, H, 1),
                                                            jnp.float32)))
        run = lambda clip: make_fused_cfg_chain(tm, sched, 2, W, N_TAIL, clip_denoised=clip,
                                                device="cpu")(torch.from_numpy(ctx), noise)
    elif builder == "ddim_chain":
        want = jax_ddim_chain(jm, params, jsched, TIMES, n_samples=2, clip_denoised=False,
                              interpret=True)(jnp.asarray(ctx), key)
        x_init = torch.from_numpy(np.array(jax.random.normal(key, (2, H, 1), jnp.float32)))
        run = lambda clip: make_fused_ddim_chain(tm, sched, TIMES, 2, clip_denoised=clip,
                                                 device="cpu")(torch.from_numpy(ctx), x_init)
    elif builder == "cfg_episode":
        want = jax_cfg_episode(jm, params, jsched, jins, jcs, jax_cp.cartpole_virtual_swingup(),
                               jax_cp.cartpole_virtual_cost(), n_steps=N_STEPS, w=W,
                               n_diffusion_steps_without_noise=N_TAIL, clip_denoised=False,
                               interpret=True)(jnp.asarray(X0), key)
        noise = torch.from_numpy(np.stack([
            np.asarray(jax.random.normal(kk, (T + N_TAIL + 1, 1, H, 1), jnp.float32))
            for kk in jax.random.split(key, N_STEPS)]))
        run = lambda clip: make_fused_cfg_episode(
            tm, sched, ins, cs, cartpole_virtual_swingup(), cartpole_virtual_cost(),
            n_steps=N_STEPS, w=W, n_diffusion_steps_without_noise=N_TAIL, clip_denoised=clip,
            device="cpu")(x0, noise)
    else:
        # on TIMES the last reconstruction saturates the controls either way; near t = 0 the
        # first one's clip moves the plan
        want = jax_ddim_episode(jm, params, jsched, TIMES_BF16, jins, jcs,
                                jax_cp.cartpole_virtual_swingup(),
                                jax_cp.cartpole_virtual_collect_cost(), n_steps=N_STEPS_DDIM,
                                clip_denoised=False, interpret=True)(jnp.asarray(X0), key)
        noise = torch.from_numpy(_jax_ddim_noise(key, N_STEPS_DDIM))
        run = lambda clip: make_fused_ddim_episode(
            tm, sched, TIMES_BF16, ins, cs, cartpole_virtual_swingup(),
            cartpole_virtual_collect_cost(), n_steps=N_STEPS_DDIM, clip_denoised=clip,
            device="cpu")(x0, noise)
    got, clipped = run(False), run(True)
    if builder.endswith("chain"):
        _rel_close(got.numpy(), want, builder)
        assert not np.allclose(clipped.numpy(), got.numpy(), rtol=0, atol=TOL)
    else:
        for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
            _rel_close(g.numpy(), w_, f"{builder} {name}")
        assert not np.allclose(clipped[1].numpy(), got[1].numpy(), rtol=0, atol=TOL)


# --------------------------------------------------------------------------- the kernels' programs

@pytest.mark.parametrize("kernel", ["fused_unet", "ddim_chain", "ddim_episode"])
def test_bf16_programs_match_plain(cluster_models, kernel):
    """The bf16 entries' programs (the emulators with ``weights_bf16``, the bf16 copy of the
    buffer they read beside it: every conv kernel from there and every product's activation
    operand rounded; the U-Net pass's final 1x1 conv outside in fp32) on the 8 NaN-filled images
    of their cluster, against the plain bf16 versions, within TOL_EMULATOR (a flipped rounding);
    without the bf16 reads they lie farther than that."""
    tm = cluster_models[2]
    rng = np.random.RandomState(9)
    h = tm.n_support_points
    sched = make_schedule("exponential", T_EMU)
    if kernel == "fused_unet":
        fused = make_fused_unet(tm, 2, weights_dtype=BF16, device="cpu")
        x = torch.from_numpy(rng.randn(2, h, 1).astype(np.float32))
        t = torch.tensor([9, 3])
        ctx = torch.from_numpy(rng.uniform(-1, 1, (2, 5)).astype(np.float32))
        mask = torch.tensor([[0.0], [1.0]])
        with torch.no_grad():
            want = fused.plain(x, t, ctx, mask)
            films = fused.films(tm.conditioning(t, ctx, mask)).numpy()
            run = lambda wb: fused.final_1x1(torch.from_numpy(emulate_fused_unet_kernel(
                fused.packed, fused.cluster.weights, films, x.numpy(), weights_bf16=wb)[0]))
            got, fp32 = run(fused.cluster.weights_bf16), run(None)
    elif kernel == "ddim_chain":
        chain = make_fused_ddim_chain(tm, sched, TIMES_BF16, 2, weights_dtype=BF16, device="cpu")
        ctx = torch.from_numpy(rng.uniform(-1, 1, (2, 5)).astype(np.float32))
        x_init = torch.from_numpy(rng.randn(2, h, 1).astype(np.float32))
        want = chain.plain(ctx, x_init)
        with torch.no_grad():
            films = chain.films(ctx).numpy()
        run = lambda wb: torch.from_numpy(emulate_ddim_chain_kernel(
            chain.packed, chain.cluster.weights, films, x_init.numpy(), chain.coefs.numpy(),
            weights_bf16=wb)[0])
        got, fp32 = run(chain.cluster.weights_bf16), run(None)
    else:
        ins, cs = _stats("torch")
        ep = make_fused_ddim_episode(tm, sched, TIMES_BF16, ins, cs, cartpole_virtual_swingup(),
                                     cartpole_virtual_collect_cost(), n_steps=1, n_candidates=2,
                                     weights_dtype=BF16, device="cpu")
        noise = torch.from_numpy(rng.randn(*ep.noise_shape).astype(np.float32))
        want = ep.plain(torch.from_numpy(X0), noise)[1] / 30.0
        run = lambda wb: torch.from_numpy(emulate_ddim_episode_kernel(
            ep.packed, ep.weights, ep.t_embs.numpy(), noise.numpy(), ep.coefs.numpy(),
            ep.consts.numpy(), X0, 2, ep.selection_horizon, 1, weights_bf16=wb)[1]) / 30.0
        got, fp32 = run(ep.cluster.weights_bf16), run(None)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL_EMULATOR)
    assert float((fp32 - want).abs().max()) > float((got - want).abs().max())


@pytest.mark.parametrize("kernel", ["cfg_chain", "cfg_chain_turns", "cfg_episode", "ddim_chain",
                                    "ddim_episode"])
def test_clip_flag_programs_match_plain(cluster_models, kernel):
    """The programs with the launch's clip flag 0 (the emulators' ``clip=False``) on the 8
    NaN-filled images of their cluster, against the plain versions with ``clip_denoised=False``
    (TOL, relative to the largest magnitude past 1); with the flag set they differ, so the clip
    binds on these inputs."""
    tm = cluster_models[2]
    rng = np.random.RandomState(10)
    h = tm.n_support_points
    sched = make_schedule("exponential", T_EMU)
    ctx = torch.from_numpy(rng.uniform(-1, 1, (1, 5)).astype(np.float32))
    ins, cs = _stats("torch")
    x0 = torch.from_numpy(X0)
    if kernel.startswith("cfg_chain"):
        chain = make_fused_cfg_chain(tm, sched, 1, W, 1, clip_denoised=False, device="cpu")
        noise = torch.from_numpy(rng.randn(T_EMU + 2, 1, h, 1).astype(np.float32))
        want = chain.plain(ctx, noise).numpy()
        with torch.no_grad():
            films = chain.films(ctx).numpy()
        noise_tab = torch.cat([noise[1:], noise[:1]]).numpy()
        emulate = emulate_cfg_chain_kernel if kernel == "cfg_chain" else emulate_cfg_chain_turns_kernel
        run = lambda clip: emulate(chain.packed, chain.cluster.weights, films, noise_tab,
                                   chain.coefs.numpy(), W, clip=clip)[0]
    elif kernel == "ddim_chain":
        chain = make_fused_ddim_chain(tm, sched, TIMES_EMU, 1, clip_denoised=False, device="cpu")
        x_init = torch.from_numpy(3 * rng.randn(1, h, 1).astype(np.float32))
        want = chain.plain(ctx, x_init).numpy()
        with torch.no_grad():
            films = chain.films(ctx).numpy()
        run = lambda clip: emulate_ddim_chain_kernel(chain.packed, chain.cluster.weights, films,
                                                     x_init.numpy(), chain.coefs.numpy(),
                                                     clip=clip)[0]
    elif kernel == "cfg_episode":
        ep = make_fused_cfg_episode(tm, sched, ins, cs, cartpole_virtual_swingup(),
                                    cartpole_virtual_cost(), n_steps=1, w=W,
                                    n_diffusion_steps_without_noise=1, clip_denoised=False,
                                    device="cpu")
        noise = torch.from_numpy(rng.randn(*ep.noise_shape).astype(np.float32))
        want = ep.plain(x0, noise)[1].numpy() / 30.0
        noise_tab = torch.cat([noise[:, 1:], noise[:, :1]], dim=1).numpy()
        run = lambda clip: emulate_cfg_episode_kernel(
            ep.packed, ep.weights, ep.t_embs.numpy(), noise_tab, ep.coefs.numpy(),
            ep.consts.numpy(), X0, W, 1, ep.selection_horizon, 1, clip=clip)[1] / 30.0
    else:
        ep = make_fused_ddim_episode(tm, sched, TIMES_BF16, ins, cs, cartpole_virtual_swingup(),
                                     cartpole_virtual_collect_cost(), n_steps=N_STEPS_EMU,
                                     clip_denoised=False, device="cpu")
        noise = torch.from_numpy(rng.randn(*ep.noise_shape).astype(np.float32))
        want = ep.plain(x0, noise)[1].numpy() / 30.0
        run = lambda clip: emulate_ddim_episode_kernel(
            ep.packed, ep.weights, ep.t_embs.numpy(), noise.numpy(), ep.coefs.numpy(),
            ep.consts.numpy(), X0, 1, ep.selection_horizon, N_STEPS_EMU, clip=clip)[1] / 30.0
    got, clipped = run(False), run(True)
    _rel_close(got, want, kernel)
    assert not np.allclose(clipped, want, rtol=0, atol=TOL)


def test_bf16_entries_of_the_ddim_episode_by_plant():
    """The DDIM episode's bf16 entries: the swing-up's, the panda arm's and the quadrotor's,
    staged and drawing its noise in the kernel; the panda's bf16 entry draws none."""
    from mpc_via_diffusion_model_tpu_torch.data.panda_stats import panda_stats
    from mpc_via_diffusion_model_tpu_torch.data.quadrotor_stats import quadrotor_stats
    from mpc_via_diffusion_model_tpu_torch.dynamics import quadrotor, quadrotor_cost
    from mpc_via_diffusion_model_tpu_torch.dynamics.arm import (make_panda_context, panda_cost,
                                                                panda_rbd_unrolled)
    sched = make_schedule("exponential", T)
    unet = lambda d, c: TemporalUnet(state_dim=d, n_support_points=H, unet_input_dim=8,
                                     dim_mults=(1, 2), context_dim=c, cfg_indicator=True)
    panda = lambda **kw: make_fused_ddim_episode(
        unet(7, 20), sched, TIMES, *panda_stats(), panda_rbd_unrolled(), panda_cost(),
        n_steps=1, state_to_condition=make_panda_context(), device="cpu", **kw)
    assert panda(weights_dtype=BF16).name == "ddim_episode_panda_bf16"
    assert panda(weights_dtype=BF16, clip_denoised=False).clip_denoised is False
    with pytest.raises(NotImplementedError, match="inkernel_noise"):
        panda(weights_dtype=BF16, inkernel_noise=True)
    for kw, name in ((dict(), "ddim_episode_quadrotor_bf16"),
                     (dict(inkernel_noise=True), "ddim_episode_quadrotor_draw_bf16")):
        ep = make_fused_ddim_episode(unet(4, 12), sched, TIMES, *quadrotor_stats(), quadrotor(),
                                     quadrotor_cost(), n_steps=1, weights_dtype=BF16,
                                     device="cpu", **kw)
        assert ep.name == name and ep.bf16
