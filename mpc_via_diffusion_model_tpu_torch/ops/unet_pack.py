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

Activations in the kernel's shared memory are (2, h + 2*HALO, c): the
conditional and unconditional copy of one sample, each with HALO zero rows
above and below, so that the 'same' convs need no edge masks. The U-Net
pass kernel and the DDIM kernels, whose samples are conditional only, use
the same plan with one row-set.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from ..models.layers import group_norm_n_groups
from ..models.temporal_unet import TemporalUnet
from ..utils.device import resolve_device

__all__ = ["PackedUnet", "pack_unet", "packed_on", "align4"]

HALO = 2
MAX_LEVELS = 4
MAX_RES = 4 * MAX_LEVELS
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper

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
EP_MISC_LEN = 32  # state, context, first control, choice (cfg_episode.cu's X_* offsets)


def align4(n: int) -> int:
    """n rounded up to a multiple of 4 floats (16 bytes)."""
    return -(-n // 4) * 4


@dataclasses.dataclass
class PackedUnet:
    model: TemporalUnet
    weights: torch.Tensor          # (n_floats,) fp32, every conv-backbone weight
    meta: torch.Tensor             # (M_LEN,) int32
    segments: Dict[str, Tuple[int, Tuple[int, ...]]]  # name -> (offset, flax shape)
    smem_bytes: int                # dynamic shared memory of one block
    films_w: torch.Tensor          # (n_res, cond_dim, max_c) FiLM Dense kernels, zero-padded
    films_b: torch.Tensor          # (n_res, max_c)
    flops_per_pass: int            # conv FLOPs of one U-Net pass over one batch element
    flops_final_1x1: int           # of which the final 1x1 conv, outside the U-Net pass kernel

    def episode_smem_bytes(self, n_candidates: int) -> int:
        """Dynamic shared memory of one block of either episode kernel. The
        DDIM episode runs one row-set: its one FiLM group fills the first
        n_res x max_c floats of the FiLM region (M_EP_FILM), and the first
        cond_dim of the mish(c_emb) region (M_EP_MC)."""
        m = self.meta
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

    # shared-memory plan: three rotating activation buffers sized for the
    # largest (2, h + 2*HALO, c) the body writes, the skips the up path
    # reads (levels >= 1), x, eps, the GroupNorm statistics, then meta.
    act = lambda h, c: 2 * (h + 2 * HALO) * c
    sizes = [act(horizon, d)]
    for lvl in range(n_levels):
        sizes.append(act(hs[lvl], dims[lvl + 1]))
        if lvl < n_levels - 1:
            sizes.append(act(hs[lvl + 1], dims[lvl + 1]))
    for u, (din, dout) in enumerate(reversed(in_out[1:])):
        h = hs[n_levels - 1 - u]
        sizes += [act(h, 2 * dout), act(h, din), act(2 * h, din)]
    sizes.append(act(horizon, dims[1]))
    align = align4
    buf = align(max(sizes))
    off = 3 * buf
    for lvl in range(1, n_levels):
        meta[M_SKIP + lvl] = off
        off += align(act(hs[lvl], dims[lvl + 1]))
    meta[M_XS] = off
    off += align(horizon * d)
    meta[M_EPS] = off
    off += align(2 * horizon * d)
    meta[M_STATS] = off
    max_groups = max(group_norm_n_groups(c) for c in dims[1:])
    off += align(4 * max_groups)
    meta[M_SMEM] = off
    smem_bytes = 4 * (off + M_LEN)
    if smem_bytes > SMEM_LIMIT:
        raise ValueError(f"the chain kernel needs {smem_bytes} B of shared memory, over {SMEM_LIMIT}")
    # the episode kernel: its regions start where the chain's meta copy does
    meta[M_EP_FILM] = off
    off += align4(len(res) * 2 * max_c)
    meta[M_EP_MC] = off
    off += align4(2 * cond_dim)
    meta[M_EP_MISC] = off
    off += EP_MISC_LEN
    meta[M_EP_SMEM] = off
    meta[[M_H, M_D, M_NLEV, M_NRES, M_MAXC, M_BUF]] = [
        horizon, d, n_levels, len(res), max(dims[1:]), buf]
    meta[M_DIMS:M_DIMS + n_levels + 1] = dims

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
        meta=torch.from_numpy(meta).to(device),
        segments=segments,
        smem_bytes=smem_bytes,
        films_w=films_w.contiguous().to(device),
        films_b=films_b.contiguous().to(device),
        flops_per_pass=flops,
        flops_final_1x1=2 * horizon * dims[1] * d,
    )


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


def _res_heights(hs, n_levels):
    """Horizon of each ResidualTemporalBlock, in call order."""
    out = []
    for lvl in range(n_levels):
        out += [hs[lvl]] * 2
    out += [hs[-1]] * 2
    for u in range(n_levels - 1):
        out += [hs[n_levels - 1 - u]] * 2
    return out
