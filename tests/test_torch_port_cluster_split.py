"""The cluster kernels' split (ops/csrc/unet_body_cluster.cuh: the CFG
episode, the CFG chain, the U-Net pass, the DDIM chain and the DDIM
episode) on the CPU: the U-Net body
computed as its 8 CTAs compute it, one output-channel slice and one GroupNorm
group per rank, against the plain ``TemporalUnet`` body; the split's plan in
``ops/unet_pack.py``; and each kernel's program emulated in numpy over 8
shared-memory images, with every push between two cluster barriers checked
for races. The CUDA checks are marked ``gpu``.
"""
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import NormalizerStats
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_virtual_collect_cost,
                                                        cartpole_virtual_cost,
                                                        cartpole_virtual_swingup,
                                                        theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.models import (TemporalUnet, load_flagship, load_student,
                                                      load_teacher)
from mpc_via_diffusion_model_tpu_torch.ops import unet_pack as up
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import (cfg_chain_max_active_clusters,
                                                                 ddim_chain_max_active_clusters,
                                                                 make_fused_cfg_chain,
                                                                 make_fused_ddim_chain)
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import (cfg_episode_max_active_clusters,
                                                                 cluster_split_features,
                                                                 ddim_episode_max_active_clusters,
                                                                 make_fused_cfg_episode,
                                                                 make_fused_ddim_episode)
from mpc_via_diffusion_model_tpu_torch.ops.fused_unet import (fused_unet_max_active_clusters,
                                                              make_fused_unet)
from mpc_via_diffusion_model_tpu_torch.ops import philox
from mpc_via_diffusion_model_tpu_torch.data.quadrotor_stats import quadrotor_stats
from mpc_via_diffusion_model_tpu_torch.dynamics import quadrotor, quadrotor_cost
from mpc_via_diffusion_model_tpu_torch.models import load_quadrotor_student
from mpc_via_diffusion_model_tpu_torch.scripts.quadrotor_task import (eval_start_states,
                                                                      make_select_cost)
from torch_port_util import (emulate_cfg_chain_kernel, emulate_cfg_episode_kernel,
                             emulate_ddim_chain_kernel, emulate_ddim_episode_kernel,
                             emulate_fused_unet_kernel, quadrotor_select, quadrotor_step_f32)

torch.set_num_threads(1)

FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts" / "flagship" / "ema_params.pkl"
STUDENT = (Path(__file__).resolve().parents[1] / "artifacts" / "onpolicy_cartpole"
           / "student_1eval.pkl")
TEACHER = (Path(__file__).resolve().parents[1] / "artifacts" / "flagship_modality"
           / "ema_params.pkl")
QUADROTOR = (Path(__file__).resolve().parents[1] / "artifacts" / "onpolicy_quadrotor"
             / "student_1eval.pkl")
GRID12 = list(range(23, 0, -2))   # the 12-eval student's grid
X0 = np.array([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], np.float32)
W = 0.01


def _seeded_unet(seed: int = 3, **kw) -> TemporalUnet:
    cfg = dict(state_dim=1, n_support_points=16, unet_input_dim=8, dim_mults=(1, 2, 4),
               context_dim=5, cfg_indicator=True)
    cfg.update(kw)
    torch.manual_seed(seed)
    tm = TemporalUnet(**cfg).eval()
    rng = np.random.RandomState(seed)
    with torch.no_grad():  # GroupNorm's affine and the biases drawn too, not left at 1 and 0
        for p in tm.parameters():
            p.copy_(torch.from_numpy((rng.randn(*p.shape) * 0.3).astype(np.float32)))
    return tm


def _model(which: str) -> TemporalUnet:
    return load_flagship(FLAGSHIP, device="cpu") if which == "flagship" else _seeded_unet()


def _stats():
    return (NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0)),
            NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0)))


def _episode(tm, k=1, n_steps=1, t=2, n_tail=1, sel_h=None, device="cpu"):
    ins, cs = _stats()
    return make_fused_cfg_episode(tm, make_schedule("exponential", t), ins, cs,
                                  cartpole_virtual_swingup(), cartpole_virtual_cost(),
                                  n_steps=n_steps, w=W, n_diffusion_steps_without_noise=n_tail,
                                  n_candidates=k, selection_horizon=sel_h, device=device)


def _chain(tm, b=1, t=2, n_tail=1, device="cpu"):
    return make_fused_cfg_chain(tm, make_schedule("exponential", t), n_samples=b, w=W,
                                n_tail=n_tail, device=device)


def _ddim_episode(tm, times, k=1, n_steps=1, sel_h=None, device="cpu"):
    ins, cs = _stats()
    return make_fused_ddim_episode(tm, make_schedule("exponential", 25), times, ins, cs,
                                   cartpole_virtual_swingup(), cartpole_virtual_collect_cost(),
                                   n_steps=n_steps, n_candidates=k, selection_horizon=sel_h,
                                   device=device)


def _ddim_chain(tm, times, b=1, device="cpu"):
    return make_fused_ddim_chain(tm, make_schedule("exponential", 25), times, n_samples=b,
                                 device=device)


def _body_barriers(dim_mults) -> int:
    """Cluster barriers of the body alone: 2 per residual block, 1 per down-
    and upsample, 1 for the final block (29 at three levels, 19 at two)."""
    return 29 if len(dim_mults) == 3 else 19


def _barriers_per_pass(dim_mults) -> int:
    """Cluster barriers of one pass of a chain or episode: the body's, and
    one more when the pass ends in a buffer the next pass pushes into, which
    happens at two levels (19 + 1)."""
    return _body_barriers(dim_mults) + (len(dim_mults) == 2)


@pytest.mark.parametrize("which", ["flagship", "small"])
def test_cluster_split_body_matches_temporal_unet(which):
    """Every conv and GroupNorm per rank's output-channel slice from the
    full input, the slices concatenated, equals the plain body: one group
    per rank, so no statistic crosses a slice (atol 1e-6). In float64: the
    split is exact in real arithmetic, and torch's CPU convs sum a slice of
    one channel in another order than a full layer, which in float32 alone
    reaches 1e-6 on the small model's drawn weights."""
    tm = _model(which).double()
    rng = np.random.RandomState(0)
    h = tm.n_support_points
    x = torch.from_numpy(rng.randn(2, h, 1))
    c = torch.from_numpy(rng.randn(2, tm.time_emb_dim + tm.context_dim + 1))  # [t_emb, ctx, bit]
    with torch.no_grad():
        got, want = cluster_split_features(tm, x, c), tm.features(x, c)
    assert got.shape == (2, h, tm.unet_input_dim)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("which", ["flagship", "small"])
def test_cluster_split_plan_channel_ranges(which):
    """The plan names every conv of the body, and the 8 ranks' channel
    ranges of each tile its output channels in rank order."""
    tm = _model(which)
    split = up.cluster_split(up.pack_unet(tm, "cpu"))
    n_res, n_lev = len(tm.res_blocks()), len(tm.in_out)
    n_wr = sum(isinstance(rb.residual_conv, torch.nn.Conv1d) for rb in tm.res_blocks())
    assert split.n_ranks == up.CLUSTER == 8
    assert len(split.convs) == 2 * n_res + n_wr + 2 * (n_lev - 1) + 1
    assert split.convs["final.w"] == tm.unet_input_dim
    assert split.convs["down0.w"] == tm.in_out[0][1] and split.convs["up0.w"] == tm.in_out[-1][0]
    for name, cout in split.convs.items():  # each names the packed kernel it splits
        assert up.pack_unet(tm, "cpu").segments[name][1][-1] == cout, name
    for name, cout in split.convs.items():
        got = [ch for r in range(8) for ch in split.channels(name, r)]
        assert got == list(range(cout)), name
        assert all(len(split.channels(name, r)) == cout // 8 for r in range(8))


@pytest.mark.parametrize("which", ["flagship", "small"])
def test_cluster_split_group_is_the_rank_slice(which):
    """Each GroupNorm's group g is exactly rank g's channel slice."""
    tm = _model(which)
    split = up.cluster_split(up.pack_unet(tm, "cpu"))
    assert len(split.norms) == 2 * len(tm.res_blocks()) + 1
    for name, (c, groups) in split.norms.items():
        assert groups == 8, name
        for g in range(groups):
            group = range(g * c // groups, (g + 1) * c // groups)
            assert split.channels(name, g) == group, (name, g)


@pytest.mark.parametrize("case", ["width_12", "width_4", "groups_16"])
def test_cluster_split_refuses_what_8_ranks_cannot_split(case):
    """A width that 8 does not divide, or a GroupNorm without 8 groups,
    raises ValueError in the plan and where the episode kernel would be
    launched (its split, which the rank-major weights need): no fallback."""
    if case == "groups_16":
        tm = _seeded_unet(unet_input_dim=32, dim_mults=(1, 2))
        tm.final_conv[0].block[2].num_groups = 16
        match = "16 groups"
    else:
        tm = _seeded_unet(unet_input_dim=int(case.split("_")[1]), dim_mults=(1, 2))
        match = "output channels"
    with pytest.raises(ValueError, match=match):
        up.cluster_split(up.pack_unet(tm, "cpu"))
    ep = _episode(tm)
    with pytest.raises(ValueError, match=match):
        ep.cluster.split


@pytest.mark.parametrize("k", [1, 4])
def test_cluster_episode_shared_memory_under_limit(k):
    """Each CTA holds the whole two-row-set plan (replicated activations,
    skips, halos) plus the episode's regions: at the flagship's widths and
    K = 1 or 4 it fits one block's shared memory."""
    ep = _episode(load_flagship(FLAGSHIP, device="cpu"), k=k)
    assert ep.smem_bytes == ep.packed.episode_smem_bytes(k, 2) <= up.SMEM_LIMIT
    assert ep.cluster.split.n_ranks == 8


@pytest.mark.parametrize("dim_mults,k,sel_h", [((1, 2), 1, None), ((1, 2, 4), 3, 5)])
def test_cluster_program_is_race_free_and_matches_plain(dim_mults, k, sel_h):
    """The kernel's program on 8 NaN-filled images: every push lands where
    no CTA reads or writes between the same two cluster barriers, all 8 CTAs
    end with the same activations, and the tracks equal the plain episode's.
    29 barriers per pass at three levels (2 per residual block, 1 per down-
    and upsample, 1 for the final block); at two levels the output lands in
    a buffer the next pass pushes into, so one more (19 + 1)."""
    tm = _seeded_unet(n_support_points=8, dim_mults=dim_mults)
    n_steps, t, n_tail = 2, 2, 1
    ep = _episode(tm, k=k, n_steps=n_steps, t=t, n_tail=n_tail, sel_h=sel_h)
    noise = torch.from_numpy(np.random.RandomState(k).randn(*ep.noise_shape).astype(np.float32))
    want = ep.plain(torch.from_numpy(X0), noise)
    noise_tab = torch.cat([noise[:, 1:], noise[:, :1]], dim=1).numpy()
    *got, barriers = emulate_cfg_episode_kernel(ep.packed, ep.weights, ep.t_embs.numpy(), noise_tab,
                                                ep.coefs.numpy(), ep.consts.numpy(), X0, W, k,
                                                ep.selection_horizon, n_steps)
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        np.testing.assert_allclose(g, w_.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got[3], want[3].numpy())
    per_pass = 29 if len(dim_mults) == 3 else 20
    assert barriers == per_pass * n_steps * (t + n_tail) * k


@pytest.mark.parametrize("dim_mults,b", [((1, 2), 1), ((1, 2), 3), ((1, 2, 4), 1),
                                         ((1, 2, 4), 3)])
def test_chain_cluster_program_is_race_free_and_matches_plain(dim_mults, b):
    """cfg_chain.cu's program, one cluster of 8 NaN-filled images per sample
    on the two row-sets (NB = 2): every push lands where no CTA reads or
    writes between the same two cluster barriers, all 8 CTAs end every pass
    with the same activations, the output equals the plain chain, and each
    cluster passes the start barrier, the body's per pass and the one before
    exit."""
    chain = _chain(_seeded_unet(n_support_points=8, dim_mults=dim_mults), b=b)
    rng = np.random.RandomState(b)
    ctx = torch.from_numpy(rng.randn(b, 5).astype(np.float32))
    noise = torch.from_numpy(rng.randn(chain.n_total + 1, b, 8, 1).astype(np.float32))
    want = chain.plain(ctx, noise).numpy()
    with torch.no_grad():
        films = chain.films(ctx).numpy()
    noise_tab = torch.cat([noise[1:], noise[:1]]).numpy()
    got, barriers = emulate_cfg_chain_kernel(chain.packed, chain.cluster.weights, films, noise_tab,
                                             chain.coefs.numpy(), W)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert barriers == [2 + _barriers_per_pass(dim_mults) * chain.n_total] * b


@pytest.mark.parametrize("dim_mults,k,times", [((1, 2), 1, [23]), ((1, 2, 4), 1, [23, 15, 7]),
                                               ((1, 2), 3, [23, 15, 7]), ((1, 2, 4), 3, [23])])
def test_ddim_cluster_program_is_race_free_and_matches_plain(dim_mults, k, times):
    """ddim_episode.cu's program, one cluster of 8 NaN-filled images through
    the episode on one row-set (NB = 1): no push races, all 8 CTAs end every
    pass alike, the tracks and choices equal the plain episode's, and the
    cluster passes the start barrier, the body's per pass (the same count as
    at NB = 2: the buffer rotation does not depend on the row-sets) and the
    one before exit."""
    n_steps = 2
    ep = _ddim_episode(_seeded_unet(n_support_points=8, dim_mults=dim_mults), times, k=k,
                       n_steps=n_steps, sel_h=5 if k > 1 else None)
    noise = torch.from_numpy(np.random.RandomState(k).randn(*ep.noise_shape).astype(np.float32))
    want = ep.plain(torch.from_numpy(X0), noise)
    *got, barriers = emulate_ddim_episode_kernel(ep.packed, ep.weights, ep.t_embs.numpy(),
                                                 noise.numpy(), ep.coefs.numpy(),
                                                 ep.consts.numpy(), X0, k, ep.selection_horizon,
                                                 n_steps)
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        np.testing.assert_allclose(g, w_.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got[3], want[3].numpy())
    assert barriers == 2 + _barriers_per_pass(dim_mults) * n_steps * len(times) * k


@pytest.mark.parametrize("dim_mults", [(1, 2), (1, 2, 4)])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("times", [[23], [23, 15, 7]])
def test_ddim_chain_cluster_program_is_race_free_and_matches_plain(dim_mults, b, times):
    """ddim_chain.cu's program, one cluster of 8 NaN-filled images per
    sample on its one row-set (NB = 1), FiLM row ``sample`` of torch's table:
    every push lands where no CTA reads or writes between the same two
    cluster barriers, all 8 CTAs end every pass with the same activations,
    the output equals the plain chain, and each cluster passes the start
    barrier, the body's per pass (with the rotation barrier at two levels)
    and the one before exit."""
    chain = _ddim_chain(_seeded_unet(n_support_points=8, dim_mults=dim_mults), times, b)
    rng = np.random.RandomState(b)
    ctx = torch.from_numpy(rng.randn(b, 5).astype(np.float32))
    x_init = torch.from_numpy(rng.randn(*chain.noise_shape).astype(np.float32))
    want = chain.plain(ctx, x_init).numpy()
    with torch.no_grad():
        films = chain.films(ctx).numpy()
    got, barriers = emulate_ddim_chain_kernel(chain.packed, chain.cluster.weights, films,
                                              x_init.numpy(), chain.coefs.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert barriers == [2 + _barriers_per_pass(dim_mults) * len(times)] * b


@pytest.mark.parametrize("kind,times,b", [("chain", GRID12, 1), ("chain", [23, 15, 7], 3),
                                          ("episode", GRID12, 1), ("episode", [23], 4)],
                         ids=["chain_12eval_b1", "chain_3eval_b3", "episode_12eval_k1",
                              "episode_1eval_k4"])
def test_ddim_programs_at_the_teachers_horizon_64(kind, times, b):
    """The DDIM chain's and episode's programs at the full width of the
    distillation's teacher (horizon 64, on the one-row-set plan 82,572 B of
    shared memory per CTA for the chain, 89,280 and 90,048 for the episode at
    K = 1 and 4), on
    its own weights: the race check on 8 NaN-filled images, the output
    against the plain version (1e-4), and the barrier counts of
    three levels."""
    tm = load_teacher(TEACHER, device="cpu")
    rng = np.random.RandomState(len(times) + b)
    if kind == "chain":
        chain = _ddim_chain(tm, times, b)
        ctx = torch.from_numpy(rng.uniform(-1, 1, (b, 5)).astype(np.float32))
        x_init = torch.from_numpy(rng.randn(*chain.noise_shape).astype(np.float32))
        want = chain.plain(ctx, x_init).numpy()
        with torch.no_grad():
            films = chain.films(ctx).numpy()
        got, barriers = emulate_ddim_chain_kernel(chain.packed, chain.cluster.weights, films,
                                                  x_init.numpy(), chain.coefs.numpy())
        assert chain.smem_bytes == 82_572
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        assert barriers == [2 + _barriers_per_pass((1, 2, 4)) * len(times)] * b
        return
    n_steps = 2 if b > 1 else 1
    ep = _ddim_episode(tm, times, k=b, n_steps=n_steps)
    noise = torch.from_numpy(rng.randn(*ep.noise_shape).astype(np.float32))
    want = ep.plain(torch.from_numpy(X0), noise)
    *got, barriers = emulate_ddim_episode_kernel(ep.packed, ep.weights, ep.t_embs.numpy(),
                                                 noise.numpy(), ep.coefs.numpy(),
                                                 ep.consts.numpy(), X0, b, ep.selection_horizon,
                                                 n_steps)
    assert ep.smem_bytes == {1: 89_280, 4: 90_048}[b]
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        np.testing.assert_allclose(g, w_.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got[3], want[3].numpy())
    assert barriers == 2 + _barriers_per_pass((1, 2, 4)) * n_steps * len(times) * b


@pytest.mark.parametrize("dim_mults", [(1, 2), (1, 2, 4)])
@pytest.mark.parametrize("batch", [1, 2])
def test_unet_pass_cluster_program_is_race_free_and_matches_plain(dim_mults, batch):
    """fused_unet.cu's program, one cluster of 8 NaN-filled images per batch
    row (NB = 1), FiLM row b: no push races, all 8 CTAs end the pass alike,
    the forward with the final 1x1 conv in torch equals the plain forward,
    and each cluster passes the start barrier, the body's (no rotation
    barrier: no pass follows) and the one before exit."""
    tm = _seeded_unet(n_support_points=8, dim_mults=dim_mults)
    fused = make_fused_unet(tm, batch_size=batch, device="cpu")
    rng = np.random.RandomState(batch)
    x = torch.from_numpy(rng.randn(batch, 8, 1).astype(np.float32))
    t = torch.from_numpy(rng.randint(0, 25, size=batch)).long()
    ctx = torch.from_numpy(rng.randn(batch, 5).astype(np.float32))
    mask = torch.tensor([[0.0], [1.0]][:batch])  # the CFG doubling: kept, dropped
    with torch.no_grad():
        want = fused.plain(x, t, ctx, mask)
        films = fused.films(tm.conditioning(t, ctx, mask)).numpy()
        y, barriers = emulate_fused_unet_kernel(fused.packed, fused.cluster.weights, films,
                                                x.numpy())
        got = fused.final_1x1(torch.from_numpy(y))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert barriers == [2 + _body_barriers(dim_mults)] * batch


@pytest.mark.parametrize("kernel,k", [("cfg_chain", 1), ("fused_unet", 2), ("ddim_chain", 4),
                                      ("ddim_episode", 1), ("ddim_episode", 4)])
def test_cluster_kernels_shared_memory_under_limit(kernel, k):
    """Each CTA of the chains', the U-Net pass's and the student's episode's
    clusters holds the whole plan of its row-sets (two for the CFG chain,
    one for the others; and the episode's regions) at the full width: the
    chains' and the pass's plan does not grow with the batch (checked at B =
    1, 4 and 2), the episode's at K = 1 and 4, within one block's shared
    memory, on a body the cluster splits."""
    if kernel in ("cfg_chain", "fused_unet", "ddim_chain"):
        if kernel == "cfg_chain":
            wrapper = _chain(load_flagship(FLAGSHIP, device="cpu"))
        elif kernel == "fused_unet":
            wrapper = make_fused_unet(load_flagship(FLAGSHIP, device="cpu"), batch_size=k,
                                      device="cpu")
        else:
            wrapper = _ddim_chain(load_student(STUDENT, device="cpu"), [23], b=k)
        smem, cluster = wrapper.smem_bytes, wrapper.cluster
        assert smem == wrapper.packed.chain_smem_bytes(2 if kernel == "cfg_chain" else 1)
    else:
        ep = _ddim_episode(load_student(STUDENT, device="cpu"), [23], k=k)
        smem, cluster = ep.smem_bytes, ep.cluster
        assert smem == ep.packed.episode_smem_bytes(k, 1)
    assert smem <= up.SMEM_LIMIT
    assert cluster.split.n_ranks == 8 and cluster.weights.shape == cluster.packed.weights.shape


@pytest.mark.parametrize("kernel", ["cfg_chain", "ddim_episode", "cfg_episode", "ddim_chain",
                                    "fused_unet"])
def test_cluster_kernels_refuse_only_where_they_would_launch(kernel):
    """A body the cluster cannot split (width 12) runs the plain chains, the
    plain U-Net pass and the plain episodes on the CPU; the rank-major
    weights, which every launch takes first, raise ValueError, and a CPU
    tensor never reaches the kernel."""
    tm = _seeded_unet(unet_input_dim=12, dim_mults=(1, 2), n_support_points=8)
    if kernel in ("cfg_chain", "ddim_chain", "fused_unet"):
        if kernel == "cfg_chain":
            wrapper = _chain(tm)
            args = (torch.zeros((1, 5)), torch.zeros((wrapper.n_total + 1, 1, 8, 1)))
        elif kernel == "ddim_chain":
            wrapper = _ddim_chain(tm, [23])
            args = (torch.zeros((1, 5)), torch.zeros(wrapper.noise_shape))
        else:
            wrapper = make_fused_unet(tm, batch_size=2, device="cpu")
            args = (torch.zeros((2, 8, 1)), torch.zeros((2,), dtype=torch.long),
                    torch.zeros((2, 5)), torch.tensor([[0.0], [1.0]]))
        out = wrapper(*args)
        assert out.shape == (2 if kernel == "fused_unet" else 1, 8, 1) and torch.isfinite(out).all()
    else:
        wrapper = _ddim_episode(tm, [23]) if kernel == "ddim_episode" else _episode(tm)
        args = (torch.from_numpy(X0), torch.zeros(wrapper.noise_shape))
        x_tr, _, _ = wrapper(*args)
        assert x_tr.shape == (2, 5) and torch.isfinite(x_tr).all()
    assert (wrapper.launches, wrapper.plain_calls) == (0, 1)
    with pytest.raises(ValueError, match="output channels"):
        wrapper.cluster.weights
    with pytest.raises(ValueError, match="CUDA"):
        wrapper.kernel(*args)
    assert wrapper.cluster.slots is None  # no occupancy query without a card


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["cfg_episode", "cfg_chain", "ddim_episode", "ddim_chain",
                                    "fused_unet"])
def test_cluster_occupancy_query_on_gpu(kernel):
    """At the full width a cluster of 8 CTAs of each cluster kernel fits at
    its shared memory: the episodes' at K = 1, the chains' and the pass's
    plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cluster occupancy query runs on the card")
    packed = up.pack_unet(load_flagship(FLAGSHIP, device="cuda"), "cuda")
    query = {"cfg_episode": cfg_episode_max_active_clusters,
             "cfg_chain": cfg_chain_max_active_clusters,
             "ddim_episode": ddim_episode_max_active_clusters,
             "ddim_chain": ddim_chain_max_active_clusters,
             "fused_unet": fused_unet_max_active_clusters}[kernel]
    nb = 2 if kernel.startswith("cfg") else 1
    smem = (packed.episode_smem_bytes(1, nb) if kernel.endswith("episode")
            else packed.chain_smem_bytes(nb))
    assert query(smem) >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_cluster_episode_kernel_matches_plain_on_gpu(k):
    """The cluster kernel against the plain episode at full width, 2 replans
    of the 25 + 5 chain (chip_smoke.py's TRACK_TOL, 1e-3), one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    ep = _episode(load_flagship(FLAGSHIP, device="cuda"), k=k, n_steps=2, t=25, n_tail=5,
                  sel_h=8 if k > 1 else None, device="cuda")
    noise = torch.randn(ep.noise_shape, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    x0 = torch.from_numpy(X0).cuda()
    got = ep.kernel(x0, noise)
    torch.cuda.synchronize()
    want = ep.plain(x0, noise)
    assert ep.launches == 1
    for g, w_ in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w_, atol=1e-3, rtol=1e-3)
    assert torch.equal(got[3], want[3])


def _quadrotor_episode(tm, times, k=1, n_steps=1, draw=False, device="cpu"):
    plant, cost = quadrotor(), quadrotor_cost()
    return make_fused_ddim_episode(tm, make_schedule("exponential", 25), times,
                                   *quadrotor_stats(), plant, cost, n_steps=n_steps,
                                   n_candidates=k, selection_cost=make_select_cost(cost) if k > 1
                                   else None, inkernel_noise=draw, device=device)


@pytest.mark.parametrize("times,b", [([23], 2), ([23, 15, 7], 1)])
def test_ddim_chain_program_at_the_quadrotors_horizon_48(times, b):
    """The DDIM chain's program on the quadrotor student at full width
    (horizon 48: levels of 48, 24 and 12 rows, the 12-row level's last conv
    item half full; 4 channels, context 12): the race check on 8 NaN-filled
    images, the output against the plain chain (1e-4), three levels'
    barriers."""
    chain = _ddim_chain(load_quadrotor_student(QUADROTOR, device="cpu"), times, b)
    assert chain.packed.horizon == 48 and chain.packed.state_dim == 4
    rng = np.random.RandomState(48 + b)
    ctx = torch.from_numpy(rng.uniform(-1, 1, (b, 12)).astype(np.float32))
    x_init = torch.from_numpy(rng.randn(*chain.noise_shape).astype(np.float32))
    want = chain.plain(ctx, x_init).numpy()
    with torch.no_grad():
        films = chain.films(ctx).numpy()
    got, barriers = emulate_ddim_chain_kernel(chain.packed, chain.cluster.weights, films,
                                              x_init.numpy(), chain.coefs.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert barriers == [2 + _barriers_per_pass((1, 2, 4)) * len(times)] * b


@pytest.mark.parametrize("k,draw", [(1, False), (4, False), (1, True), (4, True)],
                         ids=["staged_k1", "staged_k4", "draw_k1", "draw_k4"])
def test_quadrotor_episode_program_is_race_free_and_matches_plain(k, draw):
    """ddim_episode_quadrotor.cu's program at the student's full width: the
    quadrotor's step and, at K = 4, the safety-first scorer
    (``quadrotor_step_f32``, ``quadrotor_select``), the episode's misc region
    sized for the 12-state, staged noise or the in-kernel draw, where every
    rank draws each replan's noise itself and all 8 ranks' draws are equal;
    the tracks and choices against the plain episode (on the draw's table),
    race-checked on 8 NaN-filled images, the barrier counts."""
    n_steps = 2 if k > 1 else 1
    ep = _quadrotor_episode(load_quadrotor_student(QUADROTOR, device="cpu"), [23], k, n_steps, draw)
    x0 = eval_start_states(4)[2]
    if draw:
        arg = philox.seed_from_generator(torch.Generator().manual_seed(k))
        noise = ep.noise_table(arg).numpy()
        draw_fn = lambda rank, s: philox.normal_table(arg, ep.table_shape)[s].numpy()
    else:
        arg = torch.from_numpy(np.random.RandomState(k).randn(*ep.noise_shape).astype(np.float32))
        noise, draw_fn = arg.numpy(), None
    want = ep.plain(torch.from_numpy(x0), arg)
    *got, barriers = emulate_ddim_episode_kernel(
        ep.packed, ep.weights, ep.t_embs.numpy(), noise, ep.coefs.numpy(), ep.consts.numpy(), x0,
        k, ep.selection_horizon, n_steps, plant_step=quadrotor_step_f32, select=quadrotor_select(),
        draw=draw_fn)
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
        np.testing.assert_allclose(g, w_.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got[3], want[3].numpy())
    assert barriers == 2 + _barriers_per_pass((1, 2, 4)) * n_steps * k


@pytest.mark.gpu
@pytest.mark.parametrize("times", [[23], [23, 15, 7]])
def test_quadrotor_kernels_match_plain_on_gpu(times):
    """chip_smoke.py's phase 32 in short: the DDIM chain at H = 48 (B = 1
    and 4, 1e-4) and the quadrotor episode entry at K = 1 (4 replans) and
    K = 4 with the safety-first scorer (3 replans) against their plain
    versions, controls in normalized units at 1e-4, the rest at 1e-3, the
    choices equal, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    tm = load_quadrotor_student(QUADROTOR, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(32)
    for b in (1, 4):
        chain = _ddim_chain(tm, times, b, device="cuda")
        ctx = torch.rand((b, 12), generator=gen, device="cuda") * 2 - 1
        x_init = torch.randn(chain.noise_shape, generator=gen, device="cuda")
        torch.testing.assert_close(chain.kernel(ctx, x_init), chain.plain(ctx, x_init),
                                   atol=1e-4, rtol=1e-4)
    ins = quadrotor_stats()[0]
    u_unit = (0.5 * (ins.maxs - ins.mins)).cuda()
    x0 = torch.from_numpy(eval_start_states(1)[0]).cuda()
    for k, n_steps in ((1, 4), (4, 3)):
        ep = _quadrotor_episode(tm, times, k, n_steps, device="cuda")
        noise = torch.randn(ep.noise_shape, generator=gen, device="cuda")
        got = ep.kernel(x0, noise)
        torch.cuda.synchronize()
        want = ep.plain(x0, noise)
        assert ep.launches == 1
        torch.testing.assert_close(got[1] / u_unit, want[1] / u_unit, atol=1e-4, rtol=1e-4)
        for i in (0, 2):
            torch.testing.assert_close(got[i], want[i], atol=1e-3, rtol=1e-3)
        assert torch.equal(got[3], want[3])


@pytest.mark.gpu
def test_inkernel_noise_on_gpu():
    """chip_smoke.py's phase 33 in short: the draw's test entries give
    Philox's known answers and the twin's table, and the episode with the
    in-kernel draw at K = 1 and K = 8 equals the plain episode on that
    table; one seed twice gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    counters = torch.tensor([[0, 0, 0, 0], [0xFFFFFFFF] * 4], device="cuda")
    keys = torch.tensor([[0, 0], [0xFFFFFFFF] * 2], device="cuda")
    assert philox.words(counters, keys).tolist() == [
        [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
        [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]]
    seed = philox.seed_from_generator(torch.Generator().manual_seed(33)).cuda()
    torch.testing.assert_close(philox.table(seed, (4, 8, 48, 4)),
                               philox.normal_table(seed, (4, 8, 48, 4)), atol=1e-5, rtol=1e-5)
    tm = load_quadrotor_student(QUADROTOR, device="cuda")
    x0 = torch.from_numpy(eval_start_states(1)[0]).cuda()
    ins = quadrotor_stats()[0]
    u_unit = (0.5 * (ins.maxs - ins.mins)).cuda()
    for k in (1, 8):
        ep = _quadrotor_episode(tm, [23], k, 3, draw=True, device="cuda")
        got = ep.kernel(x0, seed)
        again = ep.kernel(x0, seed)
        torch.cuda.synchronize()
        want = ep.plain(x0, seed)
        assert ep.launches == 2 and all(torch.equal(a, b) for a, b in zip(got, again))
        torch.testing.assert_close(got[1] / u_unit, want[1] / u_unit, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got[0], want[0], atol=1e-3, rtol=1e-3)
        assert torch.equal(got[3], want[3])


def test_flagship_episode_quality_runs_at_a_cut_size_on_cpu():
    """``flagship_parity.run_episode_quality``, chip_smoke.py's phase 17
    through the episode, at 2 seeds of 2 replans: its plain version here."""
    from mpc_via_diffusion_model_tpu_torch.scripts import flagship_parity
    out = flagship_parity.run_episode_quality("cpu", n_seeds=2, n_steps=2)
    assert out["device"] == "cpu" and out["episode_launches"] == 0
    assert len(out["closed_loop_costs"]) == 2 and all(np.isfinite(out["closed_loop_costs"]))
    assert sum(out["modality"].values()) == 2 and out["closed_loop_cost_nmpc"] == 784750.6
    # the gate divides by the JAX package's expert on the CPU (flagship_expert_yardstick's (a))
    assert out["expert_cost"] == 784750.029296875
    assert out["cost_over_expert"] == out["closed_loop_cost_mean"] / 784750.029296875


def test_episode_recut_cuts_and_refusal_without_a_card(tmp_path):
    """scripts/episode_recut.py: its first cut is the port's own kernel (no
    settings changed), every other cut is a copy of the sources whose header
    differs from the committed one in just its settings' lines, and without
    a card it raises before building anything."""
    from mpc_via_diffusion_model_tpu_torch.ops import _build
    from mpc_via_diffusion_model_tpu_torch.scripts import episode_recut
    first, *others = episode_recut.CUTS.values()
    assert first == {}
    header = (_build.CSRC / "unet_body_cluster.cuh").read_text().splitlines()
    copies = set()
    for i, settings in enumerate(others):
        out = tmp_path / str(i)
        episode_recut.recut(_build.CSRC, out, settings)
        assert (out / "cfg_episode.cu").read_bytes() == (_build.CSRC / "cfg_episode.cu").read_bytes()
        got = (out / "unet_body_cluster.cuh").read_text()
        changed = [(a, b) for a, b in zip(header, got.splitlines()) if a != b]
        assert len(changed) == len(settings) == 1
        (name, value), = settings.items()
        assert changed[0][1].startswith(f"#define {name} {value}  //") and value != episode_recut.DEFAULTS[name]
        copies.add(got)
    assert len(copies) == len(others)  # each cut builds its own library
    with pytest.raises(RuntimeError, match="expected 1"):  # a define not as written: refused
        episode_recut.recut(tmp_path / "0", tmp_path / "bad", {"CL_RPT": 2})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            episode_recut.main(["--replans", "1"])


def test_episode_profile_marks_the_committed_sources(tmp_path):
    """scripts/episode_profile.py instruments copies of the kernel sources by
    text substitution: every marked line is found in the committed sources
    (it raises otherwise), and the copy carries a mark after every barrier
    of the cluster body."""
    from mpc_via_diffusion_model_tpu_torch.ops import _build
    from mpc_via_diffusion_model_tpu_torch.scripts import episode_profile
    episode_profile.instrument(_build.CSRC, tmp_path / "csrc")
    body = (tmp_path / "csrc" / "unet_body_cluster.cuh").read_text()
    kernel = (tmp_path / "csrc" / "cfg_episode.cu").read_text()
    committed = (_build.CSRC / "unet_body_cluster.cuh").read_text()
    assert body.count("cg::this_cluster().sync(); PROF(") == committed.count("cg::this_cluster().sync();")
    assert body.count("__syncthreads(); PROF(") == committed.count("  __syncthreads();")
    assert kernel.count("PROF(") == 4 and "cfg_episode_profile_read" in kernel
    with pytest.raises(RuntimeError, match="expected 1"):
        episode_profile._sub("int x;", "float y;", "")


class _StubEpisodeLib:
    """Answers the library checks of ``_Episode._launch`` and records them."""

    def __init__(self):
        self.asked = []

    def cfg_episode_plant_dims(self):
        self.asked.append("plant_dims")
        return 501

    def cfg_episode_consts_len(self):
        self.asked.append("consts_len")
        return 0


def test_episode_scripts_launch_their_copy_through_the_wrapper():
    """episode_recut.py and episode_profile.py launch their built copies
    through ``episode_profile.launch_copy``: its call binds to
    ``FusedCfgEpisode._launch``'s signature with the copy as ``lib``, the
    fleet's tensors (here a fleet of one) and the kernel's scalars (w,
    float32(1 + w)), and the real launch path refuses CPU tensors before it
    reads any library, the copy's too."""
    from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import FusedCfgEpisode
    from mpc_via_diffusion_model_tpu_torch.scripts import episode_profile
    ep = _episode(_seeded_unet(n_support_points=8, dim_mults=(1, 2)))
    x0 = torch.from_numpy(X0)[None]
    noise_tab = torch.zeros((1, *ep.noise_shape))
    stub, seen = _StubEpisodeLib(), []
    signature = inspect.signature(FusedCfgEpisode._launch)
    real_launch = ep._launch
    ep._launch = lambda *a, **kw: seen.append(signature.bind(ep, *a, **kw).arguments) or "launched"
    assert episode_profile.launch_copy(ep, stub, x0, noise_tab) == "launched"
    (args,) = seen
    assert args["lib"] is stub and args["x0s"] is x0 and args["noise_tab"] is noise_tab
    assert args["scalars"] == (W, float(np.float32(1.0 + W)))
    ep._launch = real_launch
    with pytest.raises(ValueError, match="CUDA"):
        episode_profile.launch_copy(ep, stub, x0, noise_tab)
    assert stub.asked == [] and ep.launches == 0


@pytest.mark.gpu
def test_episode_launch_copy_matches_the_kernel_on_gpu():
    """``launch_copy`` with the port's own built library launches the same
    kernel as ``FusedCfgEpisode.kernel``: equal tracks, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import _cfg_lib
    from mpc_via_diffusion_model_tpu_torch.scripts import episode_profile
    ep = _episode(load_flagship(FLAGSHIP, device="cuda"), n_steps=2, t=25, n_tail=5,
                  device="cuda")
    noise = torch.randn(ep.noise_shape, generator=torch.Generator(device="cuda").manual_seed(2),
                        device="cuda")
    x0 = torch.from_numpy(X0).cuda()
    want = ep.kernel(x0, noise)
    noise_tab = torch.cat([noise[:, 1:], noise[:, :1]], dim=1).contiguous()
    got = episode_profile.launch_copy(ep, _cfg_lib(), x0[None], noise_tab[None])
    torch.cuda.synchronize()
    assert ep.launches == 2
    for g, w_ in zip(got, want):
        assert torch.equal(g[0], w_)


@pytest.mark.gpu
def test_scene_episode_kernel_matches_plain_on_gpu():
    """chip_smoke.py's phase 35 in short: cfg_episode_quadrotor (the scene
    student's CFG episode: the quadrotor, the context map ConcatFeatures and
    the scene's safety-first scorer in the kernel) against its plain version
    on the card at K = 1 (3 replans) and K = 4 (2 replans), tracks within
    1e-3, controls within 1e-4 normalized, the choices equal, one launch
    each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from mpc_via_diffusion_model_tpu_torch.scripts import bench_scene_student as bss
    from mpc_via_diffusion_model_tpu_torch.data import scene_yardstick as sys_
    from mpc_via_diffusion_model_tpu_torch.models import load_scene_student
    packed = up.pack_unet(load_scene_student(sys_.STUDENT, device="cuda"), "cuda")
    sc = bss.scene(0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(35)
    x0 = torch.from_numpy(sys_.eval_starts()[0]).cuda()
    for k, n_steps in ((1, 3), (4, 2)):
        ep = bss.episode(packed, sc, k, n_steps, "cuda")
        noise = torch.randn(ep.noise_shape, generator=gen, device="cuda")
        got, want = ep.kernel(x0, noise), ep.plain(x0, noise)
        torch.testing.assert_close(got[0], want[0], rtol=1e-3, atol=1e-3)
        scale = ep.consts[2 * 24 + 4:2 * 24 + 8]
        torch.testing.assert_close(got[1] / scale, want[1] / scale, rtol=1e-4, atol=1e-4)
        assert torch.equal(got[3], want[3]) and ep.launches == 1
