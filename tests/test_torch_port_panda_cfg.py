"""The panda arm's CFG teacher in the port against the JAX package on the
CPU: the teacher's forward (``models.load_panda_teacher``), the plan of
shared memory in turns (``ops/unet_pack.py``: its bytes and regions, and
which plan and entry each CFG wrapper chooses), the in-turn programs of the
CFG chain and the CFG episode emulated in numpy with the cluster race check
(``tests/torch_port_util.py``) against their plain versions, the CFG draw's
Philox table (``ops/philox.py::cfg_normal_table``) against a direct count of
the JAX kernel's draw index, the port's chain-split loop and plain panda
CFG episode against the JAX package's loop on the same staged noise, and the
yardstick (``data/panda_teacher_yardstick.py``; it regenerates under
``slow``).

Tolerances: rtol = atol = 1e-5 for the forward (sums in other orders), 1e-4
for the emulated programs against their plain versions and for loops and
episodes (the JAX suite's, tests/test_fused_episode.py:59), with the
controls in normalized units (divided by the limits' half range), as
tests/test_torch_port_panda.py holds the student's.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu.control import make_closed_loop as jax_closed_loop
from mpc_via_diffusion_model_tpu.core.schedules import make_schedule as jax_make_schedule
from mpc_via_diffusion_model_tpu.data.normalization import NormalizerStats as JaxStats
from mpc_via_diffusion_model_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mpc_via_diffusion_model_tpu.dynamics import arm as jarm
from mpc_via_diffusion_model_tpu.dynamics import get_plant as jax_get_plant
from mpc_via_diffusion_model_tpu.models import TemporalUnet as JaxUnet
from mpc_via_diffusion_model_tpu.ops.fused_episode import _bits_to_normal
from mpc_via_diffusion_model_tpu_torch.control import make_closed_loop
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import panda_stats as ps
from mpc_via_diffusion_model_tpu_torch.data import panda_teacher_yardstick as tys
from mpc_via_diffusion_model_tpu_torch.diffusion import GaussianDiffusion
from mpc_via_diffusion_model_tpu_torch.dynamics import arm, get_plant
from mpc_via_diffusion_model_tpu_torch.models import (FLAGSHIP_CONFIG, PANDA_STUDENT_CONFIG,
                                                      TemporalUnet, from_flax_params,
                                                      load_panda_teacher)
from mpc_via_diffusion_model_tpu_torch.ops import philox
from mpc_via_diffusion_model_tpu_torch.ops import unet_pack as up
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import FusedCfgChain, make_fused_cfg_chain
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import make_fused_cfg_episode
from torch_port_util import (emulate_cfg_chain_turns_kernel, emulate_cfg_episode_turns_kernel,
                             panda_context_condition, panda_plant_step, randomize)

torch.set_num_threads(1)

TOL, FWD_TOL = 1e-4, 1e-5
N_TOTAL = tys.T + tys.N_TAIL


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class _TurnsChain(FusedCfgChain):
    """The CFG chain on the plan in turns at any shape."""
    _plans = (up.TURNS,)


@pytest.fixture(scope="module")
def teacher():
    with open(tys.TEACHER, "rb") as f:
        ckpt = pickle.load(f)
    jm = JaxUnet(conditioning_type="default", cfg_indicator=bool(ckpt["cfg_indicator"]),
                 **PANDA_STUDENT_CONFIG)
    return jm, ckpt["ema_params"], load_panda_teacher(tys.TEACHER, device="cpu")


def test_load_panda_teacher_matches_jax_forward(teacher):
    """The teacher's pickle through the port's loader against JAX's
    ``model.apply`` on it: the CFG pair of rows (mask 0 and 1) at two
    timesteps."""
    jm, params, tm = teacher
    assert tm.cfg_indicator and sum(p.numel() for p in tm.parameters()) == 1_016_615
    rng = np.random.RandomState(3)
    x = rng.randn(2, 128, 7).astype(np.float32)
    t = np.array([24, 3], np.int32)
    ctx = rng.uniform(-1, 1, (2, 20)).astype(np.float32)
    mask = np.array([[0.0], [1.0]], np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, x, t, ctx, mask))
    got = tm(_t(x), _t(t.astype(np.int64)), _t(ctx), _t(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


def test_turns_plan_bytes_regions_and_choices(teacher):
    """The plan in turns at the teacher's shape: the one-row-set plan's
    activations, skips and x, eps for two groups, the episode's FiLM and
    mish(c_emb) for two, in order and apart; 158,348 B per CTA for the
    chain, 174,928 B for the episode at K = 1 and 232,336 B at K = 17, the
    last that fits. The flagship's CFG wrappers keep the two-row-set plan
    and entries; the teacher's take the plan in turns."""
    tm = teacher[2]
    packed = up.pack_unet(tm, "cpu")
    assert packed.chain_smem_bytes(up.TURNS) == 158_348
    assert [packed.episode_smem_bytes(k, up.TURNS) for k in (1, 4, 16, 17, 18)] == [
        174_928, 185_680, 228_736, 232_336, 235_920]
    assert packed.episode_smem_bytes(17, up.TURNS) <= up.SMEM_LIMIT < packed.episode_smem_bytes(
        18, up.TURNS)
    m1, mt = (packed.metas[p].numpy() for p in (1, up.TURNS))
    same = [up.M_BUF, up.M_XS, up.M_EPS, *range(up.M_SKIP, up.M_DOWN)]
    np.testing.assert_array_equal(mt[same], m1[same])
    hd, n_res, maxc, cond = 128 * 7, int(mt[up.M_NRES]), int(mt[up.M_MAXC]), int(mt[up.M_COND])
    skips = [int(mt[up.M_SKIP + lvl]) for lvl in range(1, int(mt[up.M_NLEV]))]
    order = [3 * int(mt[up.M_BUF]), *skips, int(mt[up.M_XS]), int(mt[up.M_EPS]),
             int(mt[up.M_STATS]), int(mt[up.M_EP_FILM]), int(mt[up.M_EP_MC]),
             int(mt[up.M_EP_MISC]), int(mt[up.M_EP_SMEM])]
    assert skips[0] == order[0] and order == sorted(order) and int(mt[up.M_SMEM]) == order[6]
    assert order[5] - order[4] >= 2 * hd and order[4] - order[3] >= hd
    assert order[7] - order[6] >= n_res * 2 * maxc and order[8] - order[7] >= 2 * cond
    rest = np.setdiff1d(np.arange(up.M_LEN), [up.M_BUF, up.M_XS, up.M_EPS, up.M_STATS, up.M_SMEM,
                                              *range(up.M_SKIP, up.M_DOWN), up.M_EP_FILM,
                                              up.M_EP_MC, up.M_EP_MISC, up.M_EP_SMEM])
    np.testing.assert_array_equal(mt[rest], m1[rest])  # the architecture and the weights alike
    sched = make_schedule("exponential", tys.T)
    for bf16, entry in ((torch.float32, "cfg_chain_turns"), (torch.bfloat16, "cfg_chain_turns_bf16")):
        ch = make_fused_cfg_chain(packed, sched, n_samples=1, weights_dtype=bf16, device="cpu")
        assert (ch.plan, ch.entry, ch.smem_bytes) == (up.TURNS, entry, 158_348)
        assert ch.meta is packed.metas[up.TURNS]
    flag = TemporalUnet(cfg_indicator=True, **FLAGSHIP_CONFIG)
    fpacked = up.pack_unet(flag, "cpu")
    for bf16, entry in ((torch.float32, "cfg_chain"), (torch.bfloat16, "cfg_chain_bf16")):
        ch = make_fused_cfg_chain(fpacked, sched, n_samples=1, weights_dtype=bf16, device="cpu")
        assert (ch.plan, ch.entry, ch.smem_bytes) == (2, entry, fpacked.chain_smem_bytes(2))
    plant, cost = get_plant("cartpole_virtual_swingup")
    stats = _swingup_stats()
    for bf16, entry in ((torch.float32, "cfg_episode"), (torch.bfloat16, "cfg_episode_bf16")):
        ep = make_fused_cfg_episode(fpacked, sched, *stats, plant, cost, n_steps=1, n_candidates=4,
                                    weights_dtype=bf16, device="cpu")
        assert (ep.plan, ep.name) == (2, entry) and ep.meta is fpacked.metas[2]
    turns = _TurnsChain(fpacked, sched, 1, 0.01, 5)
    assert (turns.plan, turns.entry, turns.smem_bytes) == (
        up.TURNS, "cfg_chain_turns", fpacked.chain_smem_bytes(up.TURNS))


def _swingup_stats():
    from mpc_via_diffusion_model_tpu_torch.data import NormalizerStats
    return (NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0)),
            NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0)))


def _narrow(seed: int = 0) -> TemporalUnet:
    """A randomised CFG U-Net of the teacher's shape (horizon 128, 7 channels,
    context 20, three levels) at widths 8/16/32, the narrowest the cluster
    split takes."""
    cfg = dict(PANDA_STUDENT_CONFIG, unet_input_dim=8)
    jm = JaxUnet(conditioning_type="default", cfg_indicator=True, **cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 128, 7)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 20)), jnp.zeros((1, 1)))
    tm = TemporalUnet(cfg_indicator=True, **cfg)
    tm.load_state_dict(from_flax_params(randomize(shapes, seed, scale=0.2)))
    return tm.eval()


SHORT_T, SHORT_TAIL, SHORT_W = 3, 1, 0.5  # a short schedule; w large enough that both passes count


def test_emulated_chain_in_turns_matches_plain():
    """``cfg_chain_turns``' program in numpy at horizon 128 on the narrow
    U-Net (8 NaN-filled images of the plan in turns, the race check, eps
    written into and read back from each image) against the plain chain: 2
    samples, 3 + 1 steps; 29 cluster barriers per pass, two passes per
    step, plus the start and exit barriers."""
    tm = _narrow()
    ch = _TurnsChain(up.pack_unet(tm, "cpu"), make_schedule("exponential", SHORT_T), 2, SHORT_W,
                     SHORT_TAIL)
    rng = np.random.RandomState(4)
    ctx = _t(rng.uniform(-1, 1, (2, 20)).astype(np.float32))
    noise = _t(rng.randn(ch.n_total + 1, 2, 128, 7).astype(np.float32))
    want = ch.plain(ctx, noise).numpy()
    with torch.no_grad():
        films = ch.films(ctx).numpy()
    noise_tab = torch.cat([noise[1:], noise[:1]]).numpy()
    got, barriers = emulate_cfg_chain_turns_kernel(ch.packed, ch.cluster.weights, films, noise_tab,
                                                   ch.coefs.numpy(), SHORT_W)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert barriers == [2 + 2 * 29 * ch.n_total] * 2


@pytest.mark.parametrize("k,sel_h", [(1, None), (2, 4)])
def test_emulated_panda_cfg_episode_in_turns_matches_plain(k, sel_h):
    """``cfg_episode_panda``'s program in numpy (the plan in turns at horizon
    128, the race check, ``PandaRbd``'s and ``PandaContext``'s twins as its
    plant and condition map, the selection QuadraticCost) on the narrow
    U-Net against the plain episode, whose plant is ``panda_rbd_unrolled``
    and map ``make_panda_context``: 2 replans of 3 + 1 steps, K = 1 and K =
    2 scored over 4 steps; the chosen candidates equal."""
    _, cost = get_plant("panda")
    ep = make_fused_cfg_episode(_narrow(1), make_schedule("exponential", SHORT_T),
                                *ps.panda_stats(), arm.panda_rbd_unrolled(), cost, n_steps=2,
                                w=SHORT_W, n_diffusion_steps_without_noise=SHORT_TAIL,
                                n_candidates=k, selection_horizon=sel_h,
                                state_to_condition=arm.make_panda_context(), device="cpu")
    assert (ep.name, ep.plan) == ("cfg_episode_panda", up.TURNS)
    noise = _t(np.random.RandomState(5 + k).randn(*ep.noise_shape).astype(np.float32))
    x0 = tys.x0()
    want = ep.plain(_t(x0), noise)
    noise_tab = torch.cat([noise[:, 1:], noise[:, :1]], dim=1).numpy()
    *got, barriers = emulate_cfg_episode_turns_kernel(
        ep.packed, ep.weights, ep.t_embs.numpy(), noise_tab, ep.coefs.numpy(), ep.consts.numpy(),
        x0, SHORT_W, k, ep.selection_horizon, 2, plant_step=panda_plant_step,
        condition=panda_context_condition())
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        assert np.all(np.isfinite(g)), name
        _close(name, g, w_.numpy())
    np.testing.assert_array_equal(got[3], want[3].numpy())
    assert barriers == 2 + 2 * 29 * ep.n_total * k * 2


def test_cfg_normal_table_counts_the_jax_draw_index():
    """The CFG draw's staged table against Philox counted directly by the
    JAX kernel's draw index ``step * (n_total + 1) + si`` (x_T at si =
    n_total), its Box-Muller against JAX's ``_bits_to_normal`` on the same
    words, and at n_total = 0 the DDIM draw's table."""
    seed = torch.tensor([-5, 123456789], dtype=torch.int32)
    n_steps, n_total, k, h, d = 2, 4, 3, 5, 2
    tab = philox.cfg_normal_table(seed, n_steps, n_total, k, h, d)
    assert tab.shape == (n_steps, n_total + 1, k, h, d) and tab.dtype == torch.float32
    k0, k1 = philox.seed_words(seed)
    kk, tt, dd = torch.meshgrid(torch.arange(k), torch.arange(h), torch.arange(d), indexing="ij")
    for step in range(n_steps):
        for si in range(n_total + 1):
            w0, w1, _, _ = philox.philox4x32_10((step * (n_total + 1) + si, kk, tt, dd), (k0, k1))
            staged = 0 if si == n_total else 1 + si  # x_T first, then the injected draws
            jx = np.asarray(_bits_to_normal(jnp.asarray(w0.numpy().astype(np.uint32)),
                                            jnp.asarray(w1.numpy().astype(np.uint32))))
            np.testing.assert_array_equal(tab[step, staged].numpy(),
                                          philox.bits_to_normal(w0, w1).numpy())
            np.testing.assert_allclose(tab[step, staged].numpy(), jx, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(philox.cfg_normal_table(seed, n_steps, 0, k, h, d)[:, 0].numpy(),
                                  philox.normal_table(seed, (n_steps, k, h, d)).numpy())


def _u_unit() -> np.ndarray:
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


def _jax_loop(teacher, plant, k, sel_h, n_steps):
    """The JAX package's CFG loop of the teacher, jitted: ``(x0, key) -> result``."""
    jm, params, _ = teacher
    _, jcost = jax_get_plant("panda")
    loop = jax_closed_loop(JaxDiffusion(schedule=jax_make_schedule("exponential", tys.T)), jm.apply,
                           *_jax_stats(), plant, jcost, horizon=tys.H, n_steps=n_steps, w=tys.W,
                           n_diffusion_steps_without_noise=tys.N_TAIL, n_candidates=k,
                           state_to_condition=jarm.make_panda_context(), selection_horizon=sel_h)
    return jax.jit(lambda x0, kk: loop(params, x0, kk))


def _jax_noise(key, k: int, n_steps: int) -> np.ndarray:
    """(n_steps, n_total + 1, K, 128, 7): each replan's draws from its key of
    ``jax.random.split``, as the JAX loop draws them."""
    return np.stack([np.asarray(jax.random.normal(kk, (N_TOTAL + 1, k, tys.H, 7), jnp.float32))
                     for kk in jax.random.split(key, n_steps)])


@pytest.mark.parametrize("k,sel_h", [(1, None), (4, 16)])
def test_chain_split_loop_and_plain_episode_match_jax_loop(teacher, k, sel_h):
    """The teacher at full width, 2 replans, K = 1 and K = 4 scored over 16
    steps, on JAX's draws: the port's ``make_closed_loop`` with the CFG chain
    wrapper as ``sample_override`` (its plain version on the CPU) and the
    rigid-body arm, and the panda entry's plain episode
    (``panda_rbd_unrolled``), each against the JAX package's loop, which the
    JAX episode kernel matches (ops/fused_episode.py:433-434). The JAX loop
    steps the scan-and-solve plant, which the JAX package holds its unrolled
    one to at fp32 round-off."""
    n_steps = 2
    key = jax.random.PRNGKey(40 + k)
    x0 = tys.x0()
    want = _jax_loop(teacher, jax_get_plant("panda")[0], k, sel_h, n_steps)(jnp.asarray(x0), key)
    noise = _t(_jax_noise(key, k, n_steps))
    tm = teacher[2]
    sched = make_schedule("exponential", tys.T)
    plant, cost = get_plant("panda")
    chain = make_fused_cfg_chain(tm, sched, n_samples=k, w=tys.W, n_tail=tys.N_TAIL, device="cpu")
    got = make_closed_loop(GaussianDiffusion(sched), tm, *ps.panda_stats(), plant, cost,
                           horizon=tys.H, n_steps=n_steps, w=tys.W,
                           n_diffusion_steps_without_noise=tys.N_TAIL, n_candidates=k,
                           state_to_condition=arm.make_panda_context(), sample_override=chain,
                           selection_horizon=sel_h, device="cpu")(_t(x0), noise)
    assert (chain.launches, chain.plain_calls) == (0, n_steps)
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        _close(name, getattr(got, name).numpy(), getattr(want, name))
    ep = make_fused_cfg_episode(tm, sched, *ps.panda_stats(), arm.panda_rbd_unrolled(), cost,
                                n_steps=n_steps, w=tys.W,
                                n_diffusion_steps_without_noise=tys.N_TAIL, n_candidates=k,
                                selection_horizon=sel_h,
                                state_to_condition=arm.make_panda_context(), device="cpu")
    got = ep(_t(x0), noise)
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got,
                           (want.x_track, want.u_track, want.stage_costs)):
        _close(name, g.numpy(), w_)


def test_draw_entry_plain_runs_on_the_philox_table(teacher):
    """``inkernel_noise`` builds the draw entry, which takes a (2,) int32
    seed; its plain version is the staged plain episode on
    ``cfg_normal_table(seed)``, bit for bit; one replan at full width."""
    tm = teacher[2]
    _, cost = get_plant("panda")
    kw = dict(n_steps=1, w=tys.W, n_diffusion_steps_without_noise=tys.N_TAIL,
              state_to_condition=arm.make_panda_context(), device="cpu")
    sched = make_schedule("exponential", tys.T)
    draw = make_fused_cfg_episode(tm, sched, *ps.panda_stats(), arm.panda_rbd_unrolled(), cost,
                                  inkernel_noise=True, **kw)
    staged = make_fused_cfg_episode(draw.packed, sched, *ps.panda_stats(),
                                    arm.panda_rbd_unrolled(), cost, **kw)
    assert (draw.name, draw.plan, draw.noise_shape) == ("cfg_episode_panda_draw", up.TURNS, (2,))
    assert staged.name == "cfg_episode_panda" and draw.smem_bytes == staged.smem_bytes == 174_928
    seed = philox.seed_from_generator(torch.Generator().manual_seed(11))
    table = draw.noise_table(seed)
    assert tuple(table.shape) == staged.noise_shape
    x0 = _t(tys.x0())
    for g, w_ in zip(draw(x0, seed), staged(x0, table)):
        assert torch.equal(g, w_)
    with pytest.raises(ValueError, match="the seed must be"):
        draw(x0, table)


def test_teacher_yardstick_is_consistent_and_bounded(teacher):
    """The yardstick's rows: ten costs each, their means, their 20-replan
    prefixes below them, every bound positive and met by the yardstick
    itself; the divergence script's Philox draws are each episode's
    ``cfg_normal_table``, and its batched loop is the runtime loop over a
    batch of starts (2 starts, 1 replan)."""
    from mpc_via_diffusion_model_tpu_torch.scripts import panda_teacher_divergence as div
    assert set(tys.COSTS) == set(tys.PREFIX_COSTS) == set(tys.BOUNDS) == set(tys.ROWS)
    for row, costs in tys.COSTS.items():
        assert len(costs) == tys.N_SEEDS and tys.MEAN10[row] == pytest.approx(np.mean(costs))
        assert all(p < c for p, c in zip(tys.PREFIX_COSTS[row], costs))
        assert set(tys.BOUNDS[row]) == {"mean10", "prefix"}
        assert all(b > 0 for b in tys.BOUNDS[row].values())
        assert tys.within(row, costs, tys.PREFIX_COSTS[row])
    draws = div.staged_draws("philox", 2, n_steps=1)
    assert tuple(draws.shape) == (tys.N_SEEDS, 1, N_TOTAL + 1, 1, tys.H, 7)
    seed = philox.seed_from_generator(torch.Generator().manual_seed(2000 + 3))
    assert torch.equal(draws[3], philox.cfg_normal_table(seed, 1, N_TOTAL, 1, tys.H, 7))
    tm = teacher[2]
    starts = _t(np.stack([tys.x0(), tys.x0() * 0.5]))
    got = div.batched_stage_costs(tm, div.row_plant("chain"), starts, draws[:2])
    plant, cost = get_plant("panda")
    loop = make_closed_loop(GaussianDiffusion(make_schedule("exponential", tys.T)), tm,
                            *ps.panda_stats(), plant, cost, horizon=tys.H, n_steps=1, w=tys.W,
                            n_diffusion_steps_without_noise=tys.N_TAIL,
                            state_to_condition=arm.make_panda_context(), device="cpu")
    for i in range(2):
        np.testing.assert_allclose(got[i].numpy(), loop(starts[i], draws[i]).stage_costs.numpy(),
                                   rtol=TOL, atol=TOL)
    # (d): ten paired episodes, a bound that the literals meet and a shift of twice it fails,
    # and the paired draws are phase 48's seeds' tables
    assert len(tys.PAIRED_PREFIX) == tys.N_SEEDS and 0 < tys.PAIRED_BOUND < 1e-3
    assert tys.paired_within(tys.PAIRED_PREFIX)
    assert not tys.paired_within([c + 2 * tys.PAIRED_BOUND for c in tys.PAIRED_PREFIX])
    paired = div.paired_tables(n_steps=1)
    seed = philox.seed_from_generator(torch.Generator().manual_seed(tys.PAIRED_SEED_BASE + 5))
    assert torch.equal(paired[5], philox.cfg_normal_table(seed, 1, N_TOTAL, 1, tys.H, 7))
    shifted = div.paired_tables(n_steps=1, shift=1)
    assert torch.equal(shifted[5], philox.cfg_normal_table(seed, 2, N_TOTAL, 1, tys.H, 7)[1:])


@pytest.mark.slow
def test_teacher_paired_prefix_regenerates(teacher):
    """The port's plain episode on the CPU gives (d)'s PAIRED_PREFIX (~1
    minute at one thread; the batched loop's sums may move the last bits)."""
    from mpc_via_diffusion_model_tpu_torch.scripts import panda_teacher_divergence as div
    got = div.paired_run(teacher[2])
    np.testing.assert_allclose(got, tys.PAIRED_PREFIX, rtol=0, atol=tys.PAIRED_BOUND / 2)


@pytest.mark.slow
def test_teacher_yardstick_regenerates(teacher):
    """The JAX package's bench_highdim panda protocol on the CPU gives every
    literal of (a) and (b) of data/panda_teacher_yardstick.py (~4 min)."""
    from mpc_via_diffusion_model_tpu.data.datasets import ControlSequenceDataset
    jm, params, _ = teacher
    stats = ControlSequenceDataset.load(str(tys.TEACHER.with_name("dataset.npz"))).normalizer.stats
    keys = jax.random.split(jax.random.PRNGKey(tys.KEY_SEED), tys.N_SEEDS)
    x0 = jnp.concatenate([jnp.full((7,), 0.3), jnp.zeros(7)])
    for row, plant in tys.ROWS.items():
        jplant = jarm.panda_rbd_unrolled() if plant == "panda_rbd_unrolled" else jax_get_plant(
            "panda")[0]
        # as the JAX script jits it: the parameters an argument, the statistics the dataset's
        loop = jax.jit(jax_closed_loop(
            JaxDiffusion(schedule=jax_make_schedule("exponential", tys.T)), jm.apply,
            stats["inputs"], stats["condition"], jplant, jax_get_plant("panda")[1], horizon=tys.H,
            n_steps=tys.N_STEPS, w=tys.W, n_diffusion_steps_without_noise=tys.N_TAIL,
            state_to_condition=jarm.make_panda_context()))
        stages = [np.asarray(loop(params, x0, keys[i]).stage_costs, np.float32)
                  for i in range(tys.N_SEEDS)]
        assert tuple(float(s.astype(np.float64).sum()) for s in stages) == tys.COSTS[row]
        assert tuple(float(s[:tys.PREFIX_STEPS].astype(np.float64).sum())
                     for s in stages) == tys.PREFIX_COSTS[row]


@pytest.mark.gpu
def test_chain_in_turns_matches_plain_on_gpu():
    """``cfg_chain_turns`` on the teacher at full width against its plain
    version on the card: the full 25 + 5 chain at B = 2 (1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    tm = load_panda_teacher(tys.TEACHER, device="cuda")
    ch = make_fused_cfg_chain(tm, make_schedule("exponential", tys.T), n_samples=2,
                              n_tail=tys.N_TAIL, device="cuda")
    assert ch.plan == up.TURNS
    gen = torch.Generator(device="cuda").manual_seed(0)
    ctx = torch.rand((2, 20), generator=gen, device="cuda") * 2 - 1
    noise = torch.randn((ch.n_total + 1, 2, 128, 7), generator=gen, device="cuda")
    got = ch.kernel(ctx, noise)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ch.plain(ctx, noise), atol=TOL, rtol=TOL)
