"""The distilled student's path in the port: the DDIM chain (ops/fused_denoise.py
``FusedDdimChain``), the DDIM episode (ops/fused_episode.py
``FusedDdimEpisode``) and the closed loop with the chain as its
``sample_override``, against the JAX package's ``make_fused_ddim_chain``,
``make_fused_ddim_episode`` (interpret mode) and ``make_closed_loop``; each
kernel's program emulated in numpy on the rank-major buffer and the 8
NaN-filled shared images of its cluster; the runtime's noise layout, taken
from a DDIM chain override and else the CFG layout, unchanged.

The U-Net is small (horizon 8, ``unet_input_dim`` 8, ``dim_mults`` (1, 2),
numpy-seeded weights carried across by ``from_flax_params``), on the
cart-pole swing-up with ``bench.py``'s synthetic limits and the collection
cost the students are scored with, 3 replans: interpret mode is slow at
full width. Grids: the 1-eval student's [23], where c1 = 1 and c2 = 0, and
the 3-eval [23, 15, 7], which exercises the affine update and the step
loop. The noise is the draw the JAX code makes from each replan key of
``jax.random.split`` (fused_episode.py:384-387), handed over as numpy.
Tolerance rtol = atol = 1e-4, the JAX suite's for episodes and loops
(tests/test_fused_episode.py:59).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.control import make_closed_loop as jax_closed_loop
from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.dynamics import cartpole as jax_cp
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu.ops.fused_denoise import make_fused_ddim_chain as jax_ddim_chain
from mpc_via_diffusion_model_tpu.ops.fused_episode import make_fused_ddim_episode as jax_episode
from mpc_via_diffusion_model_tpu_torch.control import make_closed_loop, make_replan_fn
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import NormalizerStats
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.dynamics import (Plant, cartpole_virtual_collect_cost,
                                                        cartpole_virtual_swingup,
                                                        theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.diffusion.distillation import make_student_ddim_sampler
from mpc_via_diffusion_model_tpu_torch.models import TemporalUnet, from_flax_params, load_student
from mpc_via_diffusion_model_tpu_torch.models.bf16 import bf16_conv_copy
from mpc_via_diffusion_model_tpu_torch.ops import unet_pack as up
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import (make_fused_cfg_chain,
                                                                 make_fused_ddim_chain)
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import make_fused_ddim_episode
from torch_port_util import emulate_ddim_chain_kernel, emulate_ddim_episode_kernel, randomize

torch.set_num_threads(1)

STUDENT = (Path(__file__).resolve().parents[1] / "artifacts" / "onpolicy_cartpole"
           / "student_1eval.pkl")
T, N_STEPS, H = 25, 3, 8
GRIDS = ([23], [23, 15, 7])
TOL = 1e-4
X0 = np.array([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], np.float32)


@pytest.fixture(scope="module")
def models():
    cfg = dict(state_dim=1, n_support_points=H, unet_input_dim=8, dim_mults=(1, 2),
               context_dim=5, cfg_indicator=True)
    jm = JaxUnet(conditioning_type="default", **cfg)
    args = [jnp.zeros((1, H, 1)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 5)), jnp.zeros((1, 1))]
    params = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args), 71)
    tm = TemporalUnet(**cfg)
    tm.load_state_dict(from_flax_params(params))
    return jm, params, tm.eval()


def _stats(lib):
    if lib == "jax":
        return (JaxStats("limits", jnp.full((1,), -30.0), jnp.full((1,), 30.0)),
                JaxStats("limits", jnp.full((5,), -10.0), jnp.full((5,), 10.0)))
    return (NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0)),
            NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0)))


def _jax_noise(key, k: int, n_steps: int = N_STEPS) -> np.ndarray:
    """(n_steps, K, H, 1): each replan's initial draw, as the JAX episode
    stages it (fused_episode.py:384-387) and the JAX chain draws it from the
    replan key (fused_denoise.py:238)."""
    return np.stack([np.array(jax.random.normal(kk, (k, H, 1), jnp.float32))
                     for kk in jax.random.split(key, n_steps)])


def _port_episode(tm, times, k=1, sel_h=None, n_steps=N_STEPS, **kw):
    ins, cs = _stats("torch")
    return make_fused_ddim_episode(tm, make_schedule("exponential", T), times, ins, cs,
                                   cartpole_virtual_swingup(), cartpole_virtual_collect_cost(),
                                   n_steps=n_steps, n_candidates=k, selection_horizon=sel_h,
                                   device="cpu", **kw)


def _port_loop(tm, chain, k=1, sel_h=None, **kw):
    ins, cs = _stats("torch")
    return make_closed_loop(GaussianDiffusion(make_schedule("exponential", T)), tm, ins, cs,
                            cartpole_virtual_swingup(), cartpole_virtual_collect_cost(),
                            horizon=H, n_steps=N_STEPS, n_candidates=k, sample_override=chain,
                            selection_horizon=sel_h, device="cpu", **kw)


@pytest.mark.parametrize("times,k,sel_h", [(GRIDS[0], 1, None), (GRIDS[1], 1, None),
                                           (GRIDS[1], 3, 5), (GRIDS[0], 3, 4)])
def test_plain_episode_matches_jax_episode_interpret(models, times, k, sel_h):
    jm, params, tm = models
    ins, cs = _stats("jax")
    key = jax.random.PRNGKey(11 + k)
    want = jax_episode(jm, params, jax_make_schedule("exponential", T), times, ins, cs,
                       jax_cp.cartpole_virtual_swingup(), jax_cp.cartpole_virtual_collect_cost(),
                       n_steps=N_STEPS, n_candidates=k, selection_horizon=sel_h,
                       interpret=True)(jnp.asarray(X0), key)
    ep = _port_episode(tm, times, k, sel_h)
    got = ep(torch.from_numpy(X0), torch.from_numpy(_jax_noise(key, k)))
    assert (ep.launches, ep.plain_calls) == (0, 1)
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        assert g.shape == np.asarray(w_).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("times,k,sel_h", [(GRIDS[1], 1, None), (GRIDS[1], 3, None)])
def test_closed_loop_with_plain_ddim_chain_matches_jax(models, times, k, sel_h):
    """The port's make_closed_loop with a FusedDdimChain as the sampler (its
    plain version on the CPU, x_init staged per replan) against the JAX
    loop with the Pallas DDIM chain in interpret mode as its override."""
    jm, params, tm = models
    key = jax.random.PRNGKey(23 + k)
    jax_sched = jax_make_schedule("exponential", T)
    chain = jax_ddim_chain(jm, params, jax_sched, times, n_samples=k, interpret=True)
    ins, cs = _stats("jax")
    loop = jax_closed_loop(JaxDiffusion(schedule=jax_sched), jm.apply, ins, cs,
                           jax_cp.cartpole_virtual_swingup(), jax_cp.cartpole_virtual_collect_cost(),
                           horizon=H, n_steps=N_STEPS, n_candidates=k, sample_override=chain,
                           selection_horizon=sel_h)
    want = jax.jit(loop)(params, jnp.asarray(X0), key)
    port_chain = make_fused_ddim_chain(tm, make_schedule("exponential", T), times, n_samples=k,
                                       device="cpu")
    got = _port_loop(tm, port_chain, k, sel_h, noise_shape=port_chain.noise_shape)(
        torch.from_numpy(X0), torch.from_numpy(_jax_noise(key, k)))
    assert (port_chain.launches, port_chain.plain_calls) == (0, N_STEPS)
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("times,k,sel_h", [(GRIDS[0], 1, None), (GRIDS[1], 3, 5)])
def test_plain_episode_matches_port_closed_loop(models, times, k, sel_h):
    """The episode against make_closed_loop with the chain's plain version
    as the sampler on the same noise: the affine normalizers and the
    unrolled stage cost round otherwise than the runtime's, within the
    tolerance."""
    tm = models[2]
    noise = torch.from_numpy(_jax_noise(jax.random.PRNGKey(4), k))
    x_tr, u_tr, costs = _port_episode(tm, times, k, sel_h)(torch.from_numpy(X0), noise)
    chain = make_fused_ddim_chain(tm, make_schedule("exponential", T), times, n_samples=k,
                                  device="cpu")
    ref = _port_loop(tm, chain.plain, k, sel_h, noise_shape=chain.noise_shape)(
        torch.from_numpy(X0), noise)
    for name, g, w_ in (("x_track", x_tr, ref.x_track), ("u_track", u_tr, ref.u_track),
                        ("stage_costs", costs, ref.stage_costs)):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("which,times,b", [("small", GRIDS[0], 2), ("small", GRIDS[1], 3),
                                           ("student", GRIDS[0], 1), ("student", GRIDS[1], 1)])
def test_chain_kernel_program_emulation_matches_plain(models, which, times, b):
    """ddim_chain.cu's program, one cluster of 8 CTAs per sample on its one
    row-set with FiLM row b of each step, on 8 NaN-filled shared images per
    sample and the rank-major buffer the kernel reads, equals the plain
    chain: the CPU check of the kernel's offsets; at full width on the
    student."""
    tm = models[2] if which == "small" else load_student(STUDENT, device="cpu")
    chain = make_fused_ddim_chain(tm, make_schedule("exponential", T), times, n_samples=b,
                                  device="cpu")
    rng = np.random.RandomState(b)
    ctx = torch.from_numpy(rng.randn(b, 5).astype(np.float32))
    x_init = torch.from_numpy(rng.randn(*chain.noise_shape).astype(np.float32))
    want = chain.plain(ctx, x_init)
    got, _ = emulate_ddim_chain_kernel(chain.packed, chain.cluster.weights,
                                       chain.films(ctx).numpy(), x_init.numpy(),
                                       chain.coefs.numpy())
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("which,times,k,sel_h", [("small", GRIDS[0], 1, None),
                                                 ("small", GRIDS[1], 3, 5),
                                                 ("small", GRIDS[1], 3, None),
                                                 ("student", GRIDS[0], 2, 6)])
def test_episode_kernel_program_emulation_matches_plain(models, which, times, k, sel_h):
    """ddim_episode.cu's program, the one FiLM group from the packed FiLM
    weights written into the shared plan (each rank's channels), the chains
    on one row-set of the cluster body and the selection from the consts
    table, on the 8 NaN-filled shared-memory images of the episode plan,
    equals the plain episode."""
    tm = models[2] if which == "small" else load_student(STUDENT, device="cpu")
    n_steps = N_STEPS if which == "small" else 1  # numpy is slow at 128 channels
    ep = _port_episode(tm, times, k, sel_h, n_steps=n_steps)
    noise = torch.from_numpy(np.random.RandomState(k).randn(*ep.noise_shape).astype(np.float32))
    want = ep.plain(torch.from_numpy(X0), noise)
    *got, _ = emulate_ddim_episode_kernel(ep.packed, ep.weights, ep.t_embs.numpy(), noise.numpy(),
                                          ep.coefs.numpy(), ep.consts.numpy(), X0, k,
                                          ep.selection_horizon, n_steps)
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        assert np.all(np.isfinite(g)), name
        np.testing.assert_allclose(g, w_.numpy(), rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(got[3], want[3].numpy())
    assert ep.smem_bytes <= up.SMEM_LIMIT


def test_ddim_wrappers_dispatch_and_refusals(models):
    tm = models[2]
    sched = make_schedule("exponential", T)
    chain = make_fused_ddim_chain(tm, sched, GRIDS[1], n_samples=2, device="cpu")
    ctx, x_init = torch.zeros((2, 5)), torch.zeros(chain.noise_shape)
    with pytest.raises(ValueError, match="CUDA"):
        chain.kernel(ctx, x_init)  # a CPU tensor never reaches the kernel
    with pytest.raises(ValueError, match="x_init must be"):
        chain(ctx, torch.zeros((1, H, 1)))
    ep = _port_episode(tm, GRIDS[0], n_steps=1)
    noise = torch.zeros(ep.noise_shape)
    assert ep.noise_shape == (1, 1, H, 1)
    x_tr, u_tr, costs = ep(torch.from_numpy(X0), noise)
    assert x_tr.shape == (2, 5) and u_tr.shape == (1, 1) and costs.shape == (1,)
    assert (ep.launches, ep.plain_calls) == (0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        ep.kernel(torch.from_numpy(X0), noise)
    with pytest.raises(ValueError, match="noise must be"):
        ep(torch.from_numpy(X0), noise[:, :, :-1])
    # the options refused before they were ported: bf16 weights and clip_denoised=False build
    # their entries, whose plain versions are the sampler on the bf16 U-Net or without the clip;
    # weight types other than float32 and bfloat16 stay refused
    x0 = torch.from_numpy(X0)
    for kw, entries in ((dict(weights_dtype=torch.bfloat16), ("ddim_chain_bf16", "ddim_episode_bf16")),
                        (dict(clip_denoised=False), ("ddim_chain", "ddim_episode"))):
        ch = make_fused_ddim_chain(tm, sched, GRIDS[1], n_samples=2, device="cpu", **kw)
        ep_kw = _port_episode(tm, GRIDS[1], n_steps=1, **kw)
        assert (ch.entry, ep_kw.name) == entries
        model = bf16_conv_copy(tm) if kw.get("weights_dtype") == torch.bfloat16 else tm
        sampler = make_student_ddim_sampler(sched, model, GRIDS[1], kw.get("clip_denoised", True))
        x_init = 3 * torch.randn(ch.noise_shape, generator=torch.Generator().manual_seed(1))
        torch.testing.assert_close(ch(ctx, x_init), sampler(ctx, x_init), rtol=0, atol=0)
        nz = 3 * torch.randn(ep_kw.noise_shape, generator=torch.Generator().manual_seed(2))
        assert all(torch.isfinite(v).all() for v in ep_kw(x0, nz))
        assert (ep_kw.bf16, ep_kw.clip_denoised) == (ch.bf16, ch.clip_denoised)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        make_fused_ddim_chain(tm, sched, GRIDS[0], weights_dtype=torch.float16, device="cpu")
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        _port_episode(tm, GRIDS[0], weights_dtype=torch.float16)
    other = Plant("pendulum", 2, 1, 0.05, lambda x, u: x)
    ins, cs = _stats("torch")
    for kw, match in ((dict(plant=other), "pendulum"),
                      (dict(selection_cost=object()), "QuadraticCost"),
                      (dict(state_to_condition=lambda x: x), "state_to_condition"),
                      (dict(inkernel_noise=True), "inkernel_noise")):
        args = dict(plant=cartpole_virtual_swingup(), cost=cartpole_virtual_collect_cost())
        args.update(kw)
        with pytest.raises(NotImplementedError, match=match):
            make_fused_ddim_episode(tm, sched, GRIDS[0], ins, cs, device="cpu", **args)


@pytest.mark.parametrize("times,k,sel_h", [(GRIDS[0], 1, None), (GRIDS[1], 3, 5)])
def test_closed_loop_takes_the_ddim_chain_noise_shape(models, times, k, sel_h):
    """A FusedDdimChain as ``sample_override`` without ``noise_shape``: the
    runtime stages the chain's own layout (n_steps, K, H, du), and the loop
    equals the same loop with ``noise_shape`` passed, bit for bit."""
    tm = models[2]
    chain = make_fused_ddim_chain(tm, make_schedule("exponential", T), times, n_samples=k,
                                  device="cpu")
    noise = torch.from_numpy(np.random.RandomState(5 + k).randn(N_STEPS, *chain.noise_shape)
                             .astype(np.float32))
    loop = _port_loop(tm, chain, k, sel_h)
    with pytest.raises(ValueError, match=rf"\({N_STEPS}, {k}, {H}, 1\)"):
        loop(torch.from_numpy(X0), torch.zeros((N_STEPS, T + 6, k, H, 1)))
    got = loop(torch.from_numpy(X0), noise)
    assert (chain.launches, chain.plain_calls) == (0, N_STEPS)
    want = _port_loop(tm, chain, k, sel_h, noise_shape=chain.noise_shape)(torch.from_numpy(X0), noise)
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=0)
    drawn = loop(torch.from_numpy(X0), generator=torch.Generator().manual_seed(0))
    assert drawn.x_track.shape == (N_STEPS + 1, 5) and torch.isfinite(drawn.x_track).all()


@pytest.mark.parametrize("override", ["ddpm", "cfg_chain"])
def test_cfg_runtime_noise_layout_is_unchanged(models, override):
    """Without a noise_shape argument the runtime stages the CFG
    DDPM layout (n_steps, n_total + 1, K, H, du), and each replan gets its
    row: the loop's tracks are bit-identical to replanning by hand."""
    tm = models[2]
    n_tail, k = 5, 2
    ins, cs = _stats("torch")
    schedule = make_schedule("exponential", T)
    diffusion = GaussianDiffusion(schedule)
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_collect_cost()
    chain = (make_fused_cfg_chain(tm, schedule, n_samples=k, n_tail=n_tail, device="cpu")
             if override == "cfg_chain" else None)
    loop = make_closed_loop(diffusion, tm, ins, cs, plant, cost, horizon=H, n_steps=2,
                            n_candidates=k, n_diffusion_steps_without_noise=n_tail,
                            sample_override=chain, device="cpu")
    with pytest.raises(ValueError, match=r"\(2, 31, 2, 8, 1\)"):
        loop(torch.from_numpy(X0), torch.zeros((2, k, H, 1)))
    noise = torch.from_numpy(np.random.RandomState(9).randn(2, T + n_tail + 1, k, H, 1)
                             .astype(np.float32))
    res = loop(torch.from_numpy(X0), noise)
    replan = make_replan_fn(diffusion, tm, ins, cs, H, n_diffusion_steps_without_noise=n_tail,
                            n_candidates=k, plant=plant, cost=cost, sample_override=chain)
    x = torch.from_numpy(X0)
    for i in range(2):
        u_hor, _ = replan(x, noise[i])
        torch.testing.assert_close(res.u_horizons[i], u_hor, rtol=0, atol=0)
        x = plant.step(x, u_hor[0])
        torch.testing.assert_close(res.x_track[i + 1], x, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("times", GRIDS)
def test_ddim_kernels_match_plain_on_gpu(times):
    """The CUDA DDIM chain and episode kernels against their plain versions
    on the card, on the student at full width: the chain at B = 4 within
    1e-4, the episode over 4 replans at K = 1 and K = 4 (selection horizon
    8) within 1e-3 with the same choices, chip_smoke.py's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    tm = load_student(STUDENT, device="cuda")
    sched = make_schedule("exponential", T)
    gen = torch.Generator(device="cuda").manual_seed(0)
    chain = make_fused_ddim_chain(tm, sched, times, n_samples=4, device="cuda")
    ctx = torch.randn((4, 5), generator=gen, device="cuda")
    x_init = torch.randn(chain.noise_shape, generator=gen, device="cuda")
    got = chain.kernel(ctx, x_init)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, chain.plain(ctx, x_init), atol=1e-4, rtol=1e-4)
    ins, cs = _stats("torch")
    x0 = torch.from_numpy(X0).cuda()
    for k, sel_h in ((1, None), (4, 8)):
        ep = make_fused_ddim_episode(chain.packed, sched, times, ins, cs,
                                     cartpole_virtual_swingup(), cartpole_virtual_collect_cost(),
                                     n_steps=4, n_candidates=k, selection_horizon=sel_h,
                                     device="cuda")
        noise = torch.randn(ep.noise_shape, generator=gen, device="cuda")
        got = ep.kernel(x0, noise)
        torch.cuda.synchronize()
        want = ep.plain(x0, noise)
        for g, w_ in zip(got[:3], want[:3]):
            torch.testing.assert_close(g, w_, atol=1e-3, rtol=1e-3)
        assert torch.equal(got[3], want[3])
