"""Packs a ``TemporalUnet`` for the CUDA kernels (the CFG and DDIM chains and
episodes, the U-Net pass).

Counterpart of ``build_unet_ops``, ``_extract_weights``,
``time_embedding_table`` and ``stack_film_weights`` in
``mpc_via_diffusion_model_tpu/ops/fused_unet.py``. Every conv-backbone
weight goes into ONE contiguous fp32 device buffer in the flax layout
(k, C_in, C_out), C_out fastest, so that neighbouring threads of the kernel,
which own neighbouring output channels, read neighbouring weights. An int32
table (``meta``) gives the kernel the architecture, the offset of every
weight and the plans of the kernels' shared memory; ``ops/csrc/unet_body.cuh``
reads it with the indices defined here, for every library that includes it.
The FiLM Dense weights go into the same buffer, zero-padded to max_c
channels, for the episode kernel, which computes FiLM from the plant state
inside the kernel.

The JAX package probes its resampling operators numerically from the flax
layers. Here they are written out from the conv definitions instead, inside
the kernel: Downsample1d is ``out[t] = sum_k w[k] x[2t+k-1]`` and Upsample1d
(flax ConvTranspose k4 s2, no kernel flip) is
``out[2t] = w0 x[t-1] + w2 x[t]``, ``out[2t+1] = w1 x[t] + w3 x[t+1]``.

Activations in the kernel's shared memory are (NB, h + 2*HALO, c): NB
row-sets, each with HALO zero rows above and below, so that the 'same'
convs need no edge masks. The CFG kernels (the chain and the episode) hold
NB = 2 row-sets, the conditional and unconditional copy of one sample; the
U-Net pass kernel and the DDIM kernels, whose samples are conditional only,
hold NB = 1. ``pack_unet`` makes a plan of shared memory for each count,
one meta table each (``PackedUnet.metas``): the tables differ only in the
plan's offsets (M_BUF, M_SKIP, M_XS, M_EPS, M_STATS, M_SMEM and the M_EP_*
regions), so every kernel reads its own plan through the same indices. A
third plan, ``TURNS``, is the CFG kernels' where two row-sets do not fit
one block (the panda arm's H = 128 model: 304,780 B per CTA for the chain):
the conditional and the unconditional pass run one after the other on one
row-set's activations and skips, and only what outlives a pass is sized
for the two groups: eps (2, H, D), the episode's FiLM (n_res, 2, max_c)
and mish(c_emb) (2, cond_dim). A plan may exceed what a block can take;
packing does not refuse it, the kernel that would launch with it does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from ..models.layers import group_norm_n_groups
from ..models.temporal_unet import TemporalUnet
from ..utils.device import resolve_device

__all__ = ["PackedUnet", "pack_unet", "packed_on", "align4", "ClusterSplit", "cluster_split",
           "cluster_weights", "CLUSTER", "ROW_SETS", "TURNS", "PLANS", "plan_row_sets"]

HALO = 2
MAX_LEVELS = 4
MAX_RES = 4 * MAX_LEVELS
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
CLUSTER = 8  # CTAs of the cluster kernels' clusters (csrc/unet_body_cluster.cuh)
ROW_SETS = (1, 2)  # the row-set counts a plan is made for: the DDIM kernels' and the CFG kernels'
TURNS = "turns"  # the CFG kernels' plan of one row-set, its two passes in turn
PLANS = (*ROW_SETS, TURNS)
Plan = Union[int, str]


def plan_row_sets(plan: Plan) -> int:
    """The row-sets a plan's activations hold: 1 for ``TURNS``."""
    return 1 if plan == TURNS else int(plan)

# meta layout; ops/csrc/unet_body.cuh mirrors every index below
(M_H, M_D, M_NLEV, M_NRES, M_MAXC, M_BUF, M_XS, M_EPS, M_STATS, M_SMEM) = range(10)
M_DIMS = 10                          # channels: dims[0] = state_dim, dims[l+1] = level l
M_SKIP = M_DIMS + MAX_LEVELS + 1     # shared offset of the skip kept for level l (l >= 1)
M_DOWN = M_SKIP + MAX_LEVELS         # (w, b) of Downsample1d_l
M_UP = M_DOWN + 2 * MAX_LEVELS       # (w, b) of Upsample1d_j
M_FIN = M_UP + 2 * MAX_LEVELS        # final Conv1dBlock: (w, b, gamma, beta, groups)
M_F1 = M_FIN + 5                     # final 1x1 conv: (w, b)
M_RES = M_F1 + 2                     # RES_STRIDE ints per ResidualTemporalBlock
(R_CIN, R_COUT, R_GROUPS, R_W1, R_B1, R_G1, R_BE1, R_W2, R_B2, R_G2, R_BE2, R_WR, R_BR) = range(13)
RES_STRIDE = 13
# conditioning widths, the FiLM Dense weights in the packed buffer, and the
# episode kernel's shared-memory plan (FiLM of one step, mish(c_emb) of the
# two groups, state and choice, its meta copy; the K candidate chains and
# their scores follow the meta copy, sized per launch)
M_COND = M_RES + MAX_RES * RES_STRIDE
(M_TEMB, M_CTX, M_FW, M_FB, M_EP_FILM, M_EP_MC, M_EP_MISC, M_EP_SMEM) = range(M_COND + 1, M_COND + 9)
M_LEN = M_COND + 9


def ep_misc_len(context_dim: int) -> int:
    """Floats of the episode kernels' misc region (``csrc/episode.cuh``'s
    X_* offsets): the state and the context, each in a slot of the context
    width rounded up to 8, then the first control and the choice, 8 each
    (32 for the cart-poles, 48 for the 12-state quadrotor)."""
    return 2 * (8 * ((context_dim + 7) // 8)) + 16


def align4(n: int) -> int:
    """n rounded up to a multiple of 4 floats (16 bytes)."""
    return -(-n // 4) * 4


@dataclasses.dataclass
class PackedUnet:
    model: TemporalUnet
    weights: torch.Tensor          # (n_floats,) fp32, every conv-backbone weight
    metas: Dict[Plan, torch.Tensor]  # plan (PLANS) -> (M_LEN,) int32 meta table of that plan
    segments: Dict[str, Tuple[int, Tuple[int, ...]]]  # name -> (offset, flax shape)
    films_w: torch.Tensor          # (n_res, cond_dim, max_c) FiLM Dense kernels, zero-padded
    films_b: torch.Tensor          # (n_res, max_c)
    flops_per_pass: int            # conv FLOPs of one U-Net pass over one batch element
    flops_final_1x1: int           # of which the final 1x1 conv, outside the U-Net pass kernel

    def chain_smem_bytes(self, plan: Plan) -> int:
        """Dynamic shared memory of each CTA of a chain or the U-Net pass
        on ``plan`` (a row-set count, or ``TURNS``): the plan up to its meta
        copy, then the copy."""
        return 4 * (int(self.metas[plan][M_SMEM]) + M_LEN)

    def episode_smem_bytes(self, n_candidates: int, plan: Plan) -> int:
        """Dynamic shared memory of each CTA of an episode kernel's cluster on
        ``plan`` (the CFG episode 2 or ``TURNS``, the DDIM episode 1): the
        plan's FiLM (n_res x groups x max_c floats at M_EP_FILM) and
        mish(c_emb) (groups x cond_dim at M_EP_MC) regions, its misc region
        and meta copy, then the K candidate chains and their scores."""
        m = self.metas[plan]
        n = (int(m[M_EP_SMEM]) + align4(M_LEN) + align4(n_candidates * self.horizon * self.state_dim)
             + align4(n_candidates))
        return 4 * n

    @property
    def horizon(self) -> int:
        return self.model.n_support_points

    @property
    def state_dim(self) -> int:
        return self.model.state_dim


def _flax_conv(conv: torch.nn.Conv1d) -> np.ndarray:
    """torch Conv1d weight (out, in, k) -> flax kernel (k, in, out)."""
    return conv.weight.detach().cpu().numpy().transpose(2, 1, 0)


def _flax_conv_transpose(conv: torch.nn.ConvTranspose1d) -> np.ndarray:
    """torch ConvTranspose1d weight (in, out, k) -> flax kernel (k, in, out),
    un-flipping k (models/weights.py flipped it on load)."""
    return conv.weight.detach().cpu().numpy()[:, :, ::-1].transpose(2, 0, 1)


def _vec(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def pack_unet(model: TemporalUnet, device) -> PackedUnet:
    horizon, d = model.n_support_points, model.state_dim
    in_out = model.in_out
    n_levels = len(in_out)
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"the kernel takes 1..{MAX_LEVELS} levels, got {n_levels}")
    if horizon % (2 ** (n_levels - 1)):
        raise ValueError("horizon must be divisible by 2**(n_levels-1)")
    dims = [d] + [co for _, co in in_out]
    hs = [horizon >> lvl for lvl in range(n_levels)]
    meta = np.full(M_LEN, -1, np.int32)
    chunks, segments = [], {}
    n_floats = 0

    def push(name: str, a: np.ndarray) -> int:
        nonlocal n_floats
        a = np.ascontiguousarray(a, np.float32)
        off = n_floats
        segments[name] = (off, tuple(a.shape))
        pad = (-a.size) % 4  # keep every segment 16-byte aligned
        chunks.append(np.concatenate([a.ravel(), np.zeros(pad, np.float32)]))
        n_floats += a.size + pad
        return off

    res = model.res_blocks()
    for r, rb in enumerate(res):
        c1, c2 = rb.blocks[0].block, rb.blocks[1].block
        if c1[0].kernel_size != (5,):
            raise ValueError("the kernel takes k5 ResidualTemporalBlocks")
        base = M_RES + r * RES_STRIDE
        meta[base + R_CIN] = c1[0].in_channels
        meta[base + R_COUT] = c1[0].out_channels
        meta[base + R_GROUPS] = c1[2].num_groups
        meta[base + R_W1] = push(f"res{r}.w1", _flax_conv(c1[0]))
        meta[base + R_B1] = push(f"res{r}.b1", _vec(c1[0].bias))
        meta[base + R_G1] = push(f"res{r}.g1", _vec(c1[2].weight))
        meta[base + R_BE1] = push(f"res{r}.be1", _vec(c1[2].bias))
        meta[base + R_W2] = push(f"res{r}.w2", _flax_conv(c2[0]))
        meta[base + R_B2] = push(f"res{r}.b2", _vec(c2[0].bias))
        meta[base + R_G2] = push(f"res{r}.g2", _vec(c2[2].weight))
        meta[base + R_BE2] = push(f"res{r}.be2", _vec(c2[2].bias))
        if isinstance(rb.residual_conv, torch.nn.Conv1d):
            meta[base + R_WR] = push(f"res{r}.wr", _flax_conv(rb.residual_conv)[0])
            meta[base + R_BR] = push(f"res{r}.br", _vec(rb.residual_conv.bias))
    for lvl in range(n_levels - 1):
        conv = model.downs[lvl][4].conv
        meta[M_DOWN + 2 * lvl] = push(f"down{lvl}.w", _flax_conv(conv))
        meta[M_DOWN + 2 * lvl + 1] = push(f"down{lvl}.b", _vec(conv.bias))
    for j, blocks in enumerate(model.ups):
        conv = blocks[4].conv
        meta[M_UP + 2 * j] = push(f"up{j}.w", _flax_conv_transpose(conv))
        meta[M_UP + 2 * j + 1] = push(f"up{j}.b", _vec(conv.bias))
    fin, f1 = model.final_conv[0].block, model.final_conv[1]
    meta[M_FIN] = push("final.w", _flax_conv(fin[0]))
    meta[M_FIN + 1] = push("final.b", _vec(fin[0].bias))
    meta[M_FIN + 2] = push("final.g", _vec(fin[2].weight))
    meta[M_FIN + 3] = push("final.be", _vec(fin[2].bias))
    meta[M_FIN + 4] = fin[2].num_groups
    meta[M_F1] = push("final1x1.w", _flax_conv(f1)[0])
    meta[M_F1 + 1] = push("final1x1.b", _vec(f1.bias))
    max_c = max(dims[1:])
    films_w = torch.stack([
        torch.nn.functional.pad(rb.cond_mlp[1].weight.detach().T, (0, max_c - rb.cond_mlp[1].out_features))
        for rb in res])
    films_b = torch.stack([
        torch.nn.functional.pad(rb.cond_mlp[1].bias.detach(), (0, max_c - rb.cond_mlp[1].out_features))
        for rb in res])
    cond_dim = films_w.shape[1]
    meta[M_COND], meta[M_TEMB], meta[M_CTX] = cond_dim, model.time_emb_dim, model.context_dim
    meta[M_FW] = push("films.w", films_w.cpu().numpy())
    meta[M_FB] = push("films.b", films_b.cpu().numpy())

    max_groups = max(group_norm_n_groups(c) for c in dims[1:])
    meta[[M_H, M_D, M_NLEV, M_NRES, M_MAXC]] = [horizon, d, n_levels, len(res), max(dims[1:])]
    meta[M_DIMS:M_DIMS + n_levels + 1] = dims
    metas = {}
    for plan in PLANS:
        metas[plan] = meta.copy()
        _plan(metas[plan], plan_row_sets(plan), 1 if plan == 1 else 2, hs, dims, in_out,
              max_groups, len(res), max_c, cond_dim, model.context_dim)

    # conv FLOPs of one pass over one batch element (GroupNorm, Mish and the
    # adds are elementwise and left out)
    flops = 0
    for rb, h in zip(res, _res_heights(hs, n_levels)):
        cin, cout = rb.blocks[0].block[0].in_channels, rb.blocks[0].block[0].out_channels
        flops += 2 * h * 5 * (cin * cout + cout * cout)
        if isinstance(rb.residual_conv, torch.nn.Conv1d):
            flops += 2 * h * cin * cout
    for lvl in range(n_levels - 1):
        flops += 2 * hs[lvl + 1] * 3 * dims[lvl + 1] ** 2
    for u, (din, _) in enumerate(reversed(in_out[1:])):
        flops += 2 * (2 * hs[n_levels - 1 - u]) * 2 * din * din
    flops += 2 * horizon * (5 * dims[1] ** 2 + dims[1] * d)

    return PackedUnet(
        model=model,
        weights=torch.from_numpy(np.concatenate(chunks)).to(device),
        metas={plan: torch.from_numpy(m).to(device) for plan, m in metas.items()},
        segments=segments,
        films_w=films_w.contiguous().to(device),
        films_b=films_b.contiguous().to(device),
        flops_per_pass=flops,
        flops_final_1x1=2 * horizon * dims[1] * d,
    )


def _plan(meta: np.ndarray, nb: int, groups: int, hs, dims, in_out, max_groups: int, n_res: int,
          max_c: int, cond_dim: int, context_dim: int) -> None:
    """Writes the shared-memory plan of ``nb`` row-sets and ``groups`` FiLM
    groups into ``meta``: three rotating activation buffers sized for the
    largest (nb, h + 2*HALO, c) the body writes, the skips the up path reads
    (levels >= 1), x (one sample, H x D), eps (groups, H, D), the GroupNorm
    statistics, then the chains' meta copy (M_SMEM); the episodes' regions
    start there: the FiLM of one step (n_res, groups, max_c), mish(c_emb) of
    the groups, the misc region (state, context, first control, choice) and
    their meta copy. The in-turn plan is nb = 1 with groups = 2."""
    horizon, d, n_levels = hs[0], dims[0], len(hs)
    act = lambda h, c: nb * (h + 2 * HALO) * c
    sizes = [act(horizon, d)]
    for lvl in range(n_levels):
        sizes.append(act(hs[lvl], dims[lvl + 1]))
        if lvl < n_levels - 1:
            sizes.append(act(hs[lvl + 1], dims[lvl + 1]))
    for u, (din, dout) in enumerate(reversed(in_out[1:])):
        h = hs[n_levels - 1 - u]
        sizes += [act(h, 2 * dout), act(h, din), act(2 * h, din)]
    sizes.append(act(horizon, dims[1]))
    buf = align4(max(sizes))
    meta[M_BUF] = buf
    off = 3 * buf
    for lvl in range(1, n_levels):
        meta[M_SKIP + lvl] = off
        off += align4(act(hs[lvl], dims[lvl + 1]))
    meta[M_XS] = off
    off += align4(horizon * d)
    meta[M_EPS] = off
    off += align4(groups * horizon * d)
    meta[M_STATS] = off
    off += align4(4 * max_groups)
    meta[M_SMEM] = off
    meta[M_EP_FILM] = off
    off += align4(n_res * groups * max_c)
    meta[M_EP_MC] = off
    off += align4(groups * cond_dim)
    meta[M_EP_MISC] = off
    off += ep_misc_len(context_dim)
    meta[M_EP_SMEM] = off


def packed_on(model_or_packed: Union[TemporalUnet, PackedUnet], device=None) -> PackedUnet:
    """The packed U-Net on ``device`` (``cuda`` unless given), for the
    kernels' make_* functions: a ``TemporalUnet`` is moved there and packed; a
    ``PackedUnet`` is taken as it is, and must lie there already."""
    dev = resolve_device(device)
    if isinstance(model_or_packed, PackedUnet):
        if model_or_packed.weights.device.type != dev.type:
            raise ValueError(f"the packed U-Net lies on {model_or_packed.weights.device}, not {dev}")
        return model_or_packed
    return pack_unet(model_or_packed.to(dev).eval(), dev)


@dataclasses.dataclass(frozen=True)
class ClusterSplit:
    """How ``csrc/unet_body_cluster.cuh`` splits the U-Net body over the
    ``n_ranks`` CTAs of a cluster: every conv by output channel, rank r
    owning ``[r * cout / n_ranks, (r + 1) * cout / n_ranks)``, so that with
    ``n_ranks`` GroupNorm groups a rank's channels are one group.
    ``convs`` maps the packed segment of each conv kernel (``res{r}.w1``,
    ``res{r}.w2``, ``res{r}.wr``, ``down{l}.w``, ``up{j}.w``, ``final.w``) to
    its output channels, ``norms`` that of each GroupNorm's gamma
    (``res{r}.g1``, ``res{r}.g2``, ``final.g``) to (channels, groups)."""
    n_ranks: int
    convs: Dict[str, int]
    norms: Dict[str, Tuple[int, int]]

    def channels(self, name: str, rank: int) -> range:
        """The output channels of conv or GroupNorm ``name`` that ``rank`` computes."""
        c = self.convs[name] if name in self.convs else self.norms[name][0]
        nc = c // self.n_ranks
        return range(rank * nc, (rank + 1) * nc)


def cluster_split(packed: PackedUnet, n_ranks: int = CLUSTER) -> ClusterSplit:
    """The cluster kernels' split of ``packed``'s body, read from its meta
    table as the kernel reads it. Raises ``ValueError`` unless ``n_ranks``
    divides every conv's output channels and every GroupNorm has exactly
    ``n_ranks`` groups: the kernel keeps each group inside one CTA."""
    m = packed.metas[1].cpu().numpy()  # the architecture, the same in every plan
    n_levels, dims = int(m[M_NLEV]), [int(v) for v in m[M_DIMS:M_DIMS + int(m[M_NLEV]) + 1]]
    convs, norms = {}, {}
    for r in range(int(m[M_NRES])):
        rm = m[M_RES + r * RES_STRIDE:]
        cout, groups = int(rm[R_COUT]), int(rm[R_GROUPS])
        convs[f"res{r}.w1"] = convs[f"res{r}.w2"] = cout
        if rm[R_WR] >= 0:
            convs[f"res{r}.wr"] = cout
        norms[f"res{r}.g1"] = norms[f"res{r}.g2"] = (cout, groups)
    for lvl in range(n_levels - 1):
        convs[f"down{lvl}.w"] = dims[lvl + 1]
        convs[f"up{lvl}.w"] = dims[n_levels - 1 - lvl]  # the lvl-th upsample
    convs["final.w"] = dims[1]
    norms["final.g"] = (dims[1], int(m[M_FIN + 4]))
    for name, c in convs.items():
        if c % n_ranks:
            raise ValueError(f"the cluster kernels split every conv over {n_ranks} CTAs: {name} "
                             f"has {c} output channels")
    for name, (c, groups) in norms.items():
        if groups != n_ranks:
            raise ValueError(f"the cluster kernels keep one GroupNorm group per CTA: {name} has "
                             f"{groups} groups over {c} channels, not {n_ranks}")
    return ClusterSplit(n_ranks, convs, norms)


def cluster_weights(packed: PackedUnet, split: ClusterSplit) -> torch.Tensor:
    """The packed buffer as the cluster kernels read it: every conv
    kernel of the body, (rows, cout) with rows = k * C_in, stored rank-major
    as (n_ranks, rows, cout / n_ranks) at its own offset, so that each rank's
    slice is one dense block and neighbouring lanes read neighbouring
    weights; every other segment as it is. The flax layout (C_out fastest)
    leaves a rank 4-16 channels of every row, a 16-64 byte piece of each
    128-byte line."""
    w = packed.weights.clone()
    for name in split.convs:
        off, shape = packed.segments[name]
        cout, n = shape[-1], int(np.prod(shape))
        seg = w[off:off + n].view(n // cout, split.n_ranks, cout // split.n_ranks)
        w[off:off + n] = seg.transpose(0, 1).reshape(-1)
    return w


def _res_heights(hs, n_levels):
    """Horizon of each ResidualTemporalBlock, in call order."""
    out = []
    for lvl in range(n_levels):
        out += [hs[lvl]] * 2
    out += [hs[-1]] * 2
    for u in range(n_levels - 1):
        out += [hs[n_levels - 1 - u]] * 2
    return out
