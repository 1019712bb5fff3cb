"""The whole diffusion-MPC closed loop of one episode as one CUDA kernel,
beside its plain PyTorch version: the flagship's CFG episode and the
distilled student's DDIM episode.

Port of ``make_fused_cfg_episode`` (``bench.py``'s default path),
``make_fused_ddim_episode`` (``scripts/bench_deep_students.py``'s) and
``_affine_consts`` of ``mpc_via_diffusion_model_tpu/ops/fused_episode.py``.
Each maker returns a wrapper (``FusedCfgEpisode``, ``FusedDdimEpisode``);
``episode(x0, noise) -> (x_track, u_track, stage_costs)`` launches its kernel
(``csrc/cfg_episode.cu``, ``csrc/ddim_episode.cu``) when the tensors lie on
a CUDA device and runs its ``plain`` version when they lie on the CPU. On a
CUDA tensor it launches the kernel or raises: it never falls back to the
plain version.

Both episode kernels are a thread-block cluster of 8 CTAs that splits the
U-Net body by output channel, one GroupNorm group per CTA
(``csrc/unet_body_cluster.cuh``; two row-sets in the CFG episode, one in the
DDIM episode): they need a card with clusters (sm_90), and a model whose
convs and GroupNorms ``unet_pack.cluster_split`` accepts, which each
wrapper checks where its kernel would be launched, so that its plain version
on the CPU takes any model. Before its first launch each wrapper asks CUDA
(``cudaOccupancyMaxActiveClusters``) how many such clusters fit on the card
at the episode's shared memory, and raises when none does
(``_build.ClusterLaunch``). ``cluster_split_features`` is
the body computed as the 8 CTAs compute it, in plain PyTorch, for the tests.

``noise`` is staged per replan as the port's ``make_closed_loop`` takes it
from the matching sampler. The CFG episode's is (n_steps, n_total + 1, K, H,
du): per replan ``[0]`` is x_T and ``[1 + s]`` is injected at step s; the
kernel gets it reordered so that x_T comes after the injected draws
(fused_episode.py:635-645). The DDIM episode's is (n_steps, K, H, du), each
replan's initial draw: JAX's (n_steps, K * H, du) of fused_episode.py:384-387
with the candidate axis kept.

What the kernels run, and what raises ``NotImplementedError`` because they
do not: the plants written as device functions in ``csrc/plants.cuh``, a
``QuadraticCost`` for the stage cost and for the selection, the identity
``state_to_condition``, and staged noise (no ``inkernel_noise``). Each
(plant, weights) pair the CFG episode runs is an entry of its own
(``CFG_ENTRIES``): the cart-pole swing-up with float32 weights
(``cfg_episode``) or bfloat16 ones (``bench.py``'s ``BENCH_BF16``: the
kernel's bf16 entry, ``cfg_episode_bf16``, with ``plain`` running the U-Net
of ``models/bf16.py``), and the linear cart-pole of the LMPC workload with
float32 weights (``cfg_episode_lmpc``: ``cfg_episode.cu`` compiled for that
plant, ``csrc/cfg_episode_lmpc.cu``, whose A_d and B_d follow dt in the
consts table). The DDIM episode runs the swing-up with float32 weights and
``clip_denoised=True`` only. Nothing falls back to another path.

Best-of-K follows the JAX episode kernels, not the JAX runtime: the first
candidate whose score equals the minimum wins, and when a score is NaN the
minimum is NaN, no candidate is chosen and the applied control is the
one-hot product ``sum_k 0 * u_k[0]`` (fused_episode.py:612-616). The
runtime (``control/runtime.py``) picks the first NaN, as ``jnp.argmin``
does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.schedules import DiffusionSchedule
from ..data.normalization import NormalizerStats
from ..diffusion.distillation import make_student_ddim_sampler
from ..dynamics.base import Plant, QuadraticCost
from ..models.bf16 import bf16_conv_copy
from ..models.layers import mish
from ..models.temporal_unet import TemporalUnet
from . import _build
from .fused_denoise import (ddim_step_coefficients, is_bf16, refuse_unported_ddim_options,
                            step_coefficients)
from .unet_pack import CLUSTER, M_LEN, SMEM_LIMIT, PackedUnet, packed_on

__all__ = ["FusedCfgEpisode", "FusedDdimEpisode", "make_fused_cfg_episode",
           "make_fused_ddim_episode", "affine_consts", "episode_choice", "CFG_ENTRIES",
           "DDIM_ENTRIES", "cfg_episode_max_active_clusters",
           "cfg_episode_bf16_max_active_clusters", "cfg_episode_lmpc_max_active_clusters",
           "ddim_episode_max_active_clusters", "cluster_split_features"]

# the entry of each episode kernel for (plant name, bf16 weights): plants written in
# csrc/plants.cuh, each entry with its own library symbols and occupancy query
CFG_ENTRIES = {("cartpole_virtual_swingup", False): "cfg_episode",
               ("cartpole_virtual_swingup", True): "cfg_episode_bf16",
               ("cartpole_lmpc", False): "cfg_episode_lmpc"}
DDIM_ENTRIES = {("cartpole_virtual_swingup", False): "ddim_episode"}
_QUERIES = ("consts_len", "plant_dims")


@functools.lru_cache(maxsize=None)
def _cfg_lib() -> ctypes.CDLL:
    """The built ``csrc/cfg_episode.cu``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind("cfg_episode", [p, p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, f, f, p],
                       M_LEN, _QUERIES, cluster=CLUSTER)


def cfg_episode_max_active_clusters(smem_bytes: int) -> int:
    """How many clusters of the CFG episode kernel fit on the current CUDA
    device at once with ``smem_bytes`` of dynamic shared memory per CTA
    (``cudaOccupancyMaxActiveClusters``); raises with CUDA's text when the
    query fails. Builds the kernel first if needed."""
    return _build.max_active_clusters(_cfg_lib(), "cfg_episode", smem_bytes)


@functools.lru_cache(maxsize=None)
def _cfg_bf16_lib() -> ctypes.CDLL:
    """The built ``csrc/cfg_episode.cu``, its bf16 entry declared."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind("cfg_episode_bf16",
                       [p, p, p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, f, f, p],
                       M_LEN, _QUERIES, cluster=CLUSTER, source="cfg_episode")


def cfg_episode_bf16_max_active_clusters(smem_bytes: int) -> int:
    """The same query for the episode kernel's bf16 instantiation."""
    return _build.max_active_clusters(_cfg_bf16_lib(), "cfg_episode_bf16", smem_bytes)


@functools.lru_cache(maxsize=None)
def _cfg_lmpc_lib() -> ctypes.CDLL:
    """The built ``csrc/cfg_episode_lmpc.cu``: the CFG episode for the linear cart-pole."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind("cfg_episode_lmpc", [p, p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, f, f, p],
                       M_LEN, _QUERIES, cluster=CLUSTER)


def cfg_episode_lmpc_max_active_clusters(smem_bytes: int) -> int:
    """The same query for the linear cart-pole's CFG episode entry."""
    return _build.max_active_clusters(_cfg_lmpc_lib(), "cfg_episode_lmpc", smem_bytes)


# each CFG entry's library and occupancy query
_CFG_LIBS = {"cfg_episode": (_cfg_lib, cfg_episode_max_active_clusters),
             "cfg_episode_bf16": (_cfg_bf16_lib, cfg_episode_bf16_max_active_clusters),
             "cfg_episode_lmpc": (_cfg_lmpc_lib, cfg_episode_lmpc_max_active_clusters)}


@functools.lru_cache(maxsize=None)
def _ddim_lib() -> ctypes.CDLL:
    """The built ``csrc/ddim_episode.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("ddim_episode", [p, p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, p],
                       M_LEN, _QUERIES, cluster=CLUSTER)


def ddim_episode_max_active_clusters(smem_bytes: int) -> int:
    """The same query for the DDIM episode kernel's cluster."""
    return _build.max_active_clusters(_ddim_lib(), "ddim_episode", smem_bytes)


def affine_consts(stats: NormalizerStats, dim: int):
    """(n_shift, n_scale, u_shift, u_scale) in float32 numpy, so that
    normalize(x) = (x - n_shift) * n_scale and unnormalize(u) =
    clip(u, -1, 1) * u_scale + u_shift, computed as the JAX package's
    ``_affine_consts`` does (fused_episode.py:99-116). This rounds otherwise
    than ``data/normalization.py``. Limits and identity kinds only."""
    if stats.kind == "identity":
        z, o = np.zeros((dim,), np.float32), np.ones((dim,), np.float32)
        return z, o, z, o
    if stats.kind != "limits":
        raise NotImplementedError(f"the episode takes limits or identity normalizers, not {stats.kind}")
    mins = np.asarray(stats.mins.cpu(), np.float32)
    maxs = np.asarray(stats.maxs.cpu(), np.float32)
    rng = maxs - mins
    n_shift = mins + 0.5 * rng
    n_scale = 2.0 / rng
    u_scale = 0.5 * rng
    u_shift = mins + 0.5 * rng
    return n_shift, n_scale, u_shift, u_scale


def episode_choice(scores: torch.Tensor) -> int:
    """The episode kernels' best-of-K rule (fused_episode.py:612-614): the
    first index whose score equals the minimum; K when the minimum is NaN,
    which chooses no candidate."""
    k = scores.shape[0]
    hits = torch.nonzero(scores == torch.min(scores))
    return int(hits[0, 0]) if hits.numel() else k


class _Episode:
    """What the two episodes share: the consts table of the kernels
    (``csrc/episode.cuh``, C_*), the shared-memory size, the cluster launch
    (``cluster``: the rank-major weights and the occupancy check), the
    checks, the dispatch between kernel and plain version and, in the plain
    version, the end of each replan."""

    name = ""  # the kernel's entry (CFG_ENTRIES, DDIM_ENTRIES)
    lib: Callable[[], ctypes.CDLL]  # its built library, the entry declared
    query: Callable[[int], int]  # its <name>_max_active_clusters
    bf16 = False  # bf16 conv weights: the bf16 entry, which also reads cluster.weights_bf16

    def __init__(self, packed: PackedUnet, inputs_stats: NormalizerStats,
                 condition_stats: NormalizerStats, plant: Plant, cost: QuadraticCost,
                 n_steps: int, n_candidates: int, selection_cost: QuadraticCost,
                 selection_horizon: int, coefs: np.ndarray, t_eval: np.ndarray):
        self.packed, self.model = packed, packed.model
        self.cluster = _build.ClusterLaunch(packed, self.name, self.query)
        self.plant, self.n_steps = plant, int(n_steps)
        self.n_candidates, self.selection_horizon = int(n_candidates), int(selection_horizon)
        device = packed.weights.device
        self.n_total = len(t_eval)
        self.coefs = torch.tensor(coefs, dtype=torch.float32, device=device)
        self.t_eval = torch.as_tensor(t_eval, device=device)
        with torch.no_grad():
            self.t_embs = self.model.time_mlp(self.t_eval).contiguous()  # (n_total, time_emb_dim)
        dx, du = plant.state_dim, plant.control_dim
        cn_shift, cn_scale, _, _ = affine_consts(condition_stats, dx)
        _, _, un_shift, un_scale = affine_consts(inputs_stats, du)
        vec = lambda t, n: np.broadcast_to(np.asarray(t.cpu(), np.float32).reshape(-1), (n,))
        self.consts = torch.from_numpy(np.concatenate([
            cn_shift, cn_scale, un_shift, un_scale,
            vec(cost.q_diag, dx), vec(cost.r, du),
            vec(selection_cost.q_diag, dx), vec(selection_cost.r, du), vec(selection_cost.p_diag, dx),
            np.float32([plant.dt]), np.float32(plant.device_consts)]).astype(np.float32)).to(device)
        self.cost, self.selection_cost = cost.to(device), selection_cost.to(device)
        self.smem_bytes = packed.episode_smem_bytes(self.n_candidates)
        if self.smem_bytes > SMEM_LIMIT:
            raise ValueError(f"the episode kernel needs {self.smem_bytes} B of shared memory at "
                             f"K = {self.n_candidates}, over {SMEM_LIMIT}")
        self.launches = 0
        self.plain_calls = 0
        self.plain_scores: Optional[torch.Tensor] = None
        self.last_chosen: Optional[torch.Tensor] = None

    @property
    def weights(self) -> torch.Tensor:
        """The buffer the kernel reads: the packed weights with the body's
        conv kernels rank-major."""
        return self.cluster.weights

    def _check(self, x0: torch.Tensor, noise: torch.Tensor) -> None:
        if tuple(x0.shape) != (self.plant.state_dim,):
            raise ValueError(f"x0 must be ({self.plant.state_dim},), got {tuple(x0.shape)}")
        if tuple(noise.shape) != self.noise_shape:
            raise ValueError(f"noise must be {self.noise_shape}, got {tuple(noise.shape)}")
        if x0.dtype != torch.float32 or noise.dtype != torch.float32:
            raise ValueError("x0 and noise must be float32")
        if x0.device != noise.device:
            raise ValueError("x0 and noise must lie on one device")

    def episode(self, x0: torch.Tensor, noise: torch.Tensor):
        out = self.plain(x0, noise) if x0.device.type == "cpu" else self.kernel(x0, noise)
        self.last_chosen = out[3]  # the applied candidate of every replan
        return out[:3]

    __call__ = episode

    def _launch(self, x0: torch.Tensor, noise_tab: torch.Tensor, *scalars,
                lib: Optional[ctypes.CDLL] = None):
        """Checks the library (the port's ``lib()`` unless another build of
        ``<name>.cu`` is given, as the scripts that time edited copies give
        theirs) against this wrapper, asks once whether its cluster fits,
        allocates the outputs and launches ``<name>_launch``, one cluster of
        8 CTAs, on the current stream; returns (x_track, u_track, costs,
        chosen)."""
        if not x0.is_cuda or x0.device != self.packed.weights.device:
            raise ValueError(f"the {self.name} kernel takes tensors on the packed weights' CUDA device")
        weights = [self.weights] + ([self.cluster.weights_bf16] if self.bf16 else [])
        lib = self.lib() if lib is None else lib
        dev, dx, du = x0.device, self.plant.state_dim, self.plant.control_dim
        if getattr(lib, f"{self.name}_plant_dims")() != 100 * dx + du:
            raise RuntimeError(f"{self.name}.cu was built for another plant")
        if getattr(lib, f"{self.name}_consts_len")() != self.consts.numel():
            raise RuntimeError(f"{self.name}.cu and fused_episode.py disagree on the consts layout")
        self.cluster.require_fit(self.smem_bytes, x0.device)
        x_track = torch.empty((self.n_steps + 1, dx), dtype=torch.float32, device=dev)
        u_track = torch.empty((self.n_steps, du), dtype=torch.float32, device=dev)
        costs = torch.empty((self.n_steps,), dtype=torch.float32, device=dev)
        chosen = torch.empty((self.n_steps,), dtype=torch.int32, device=dev)
        x0 = x0.contiguous()
        _build.launch(
            lib, self.name,
            *(wt.data_ptr() for wt in weights), self.packed.meta.data_ptr(), self.smem_bytes,
            self.t_embs.data_ptr(), noise_tab.data_ptr(), self.coefs.data_ptr(),
            self.consts.data_ptr(), x0.data_ptr(), x_track.data_ptr(), u_track.data_ptr(),
            costs.data_ptr(), chosen.data_ptr(), self.n_steps, self.n_total, self.n_candidates,
            self.selection_horizon, *scalars, torch.cuda.current_stream(dev).cuda_stream)
        self.launches += 1
        return x_track, u_track, costs, chosen

    def _plain_loop(self, x0: torch.Tensor, noise: torch.Tensor, sample: Callable):
        """The plain episode around ``sample(ctx (dx,), noise_of_replan) ->
        u_norm (K, H, du)``, the chain of one replan in the kernel's
        arithmetic: the affine normalize, the chain, the clip and
        unnormalize, the candidate rollouts and the first-min choice, the
        unrolled stage cost and the plant step. At K > 1 it keeps every
        replan's candidate scores in ``plain_scores`` (n_steps, K), which
        tell a near-tie from a real choice."""
        self._check(x0, noise)
        self.plain_calls += 1
        c = self.consts
        dx, du = self.plant.state_dim, self.plant.control_dim
        cn_shift, cn_scale = c[:dx], c[dx:2 * dx]
        un_shift, un_scale = c[2 * dx:2 * dx + du], c[2 * dx + du:2 * dx + 2 * du]
        k, horizon, dev = self.n_candidates, self.packed.horizon, x0.device
        q = [float(v) for v in self.cost.q_diag.reshape(-1)]
        r = [float(v) for v in self.cost.r.reshape(-1).expand(du)]
        x = x0
        xs, us, stages, chosen, scores = [x0], [], [], [], []
        for step in range(self.n_steps):
            u = sample((x - cn_shift) * cn_scale, noise[step])
            u_seq = torch.clamp(u, -1.0, 1.0) * un_scale + un_shift  # (K, H, du)
            if k == 1:
                best, u0 = 0, u_seq[0, 0]
            else:
                xc = x[None].expand(k, dx)
                acc = torch.zeros((k,), dtype=torch.float32, device=dev)
                for i in range(self.selection_horizon):
                    acc = acc + self.selection_cost.stage(xc, u_seq[:, i])
                    xc = self.plant.step(xc, u_seq[:, i])
                if self.selection_horizon == horizon:
                    acc = acc + self.selection_cost.terminal(xc)
                best = episode_choice(acc)
                scores.append(acc)
                onehot = (torch.arange(k, device=dev) == best).to(torch.float32)
                u0 = onehot @ u_seq[:, 0]
            stage = q[0] * x[0] * x[0]
            for i in range(1, dx):
                stage = stage + q[i] * x[i] * x[i]
            su = r[0] * u0[0] * u0[0]
            for j in range(1, du):
                su = su + r[j] * u0[j] * u0[j]
            stages.append(stage + su)
            x = self.plant.step(x, u0)
            xs.append(x)
            us.append(u0)
            chosen.append(best)
        self.plain_scores = torch.stack(scores) if scores else None
        return (torch.stack(xs), torch.stack(us), torch.stack(stages),
                torch.tensor(chosen, dtype=torch.int32, device=dev))


class FusedCfgEpisode(_Episode):
    """``episode(x0 (dx,), noise (n_steps, n_total+1, K, H, du)) ->
    (x_track (n_steps+1, dx), u_track (n_steps, du), stage_costs (n_steps,))``.

    ``kernel`` and ``plain`` also return the index of the applied candidate
    at every replan (K where none was chosen). ``launches`` counts kernel
    launches and ``plain_calls`` calls of the plain version; callers reset
    them to 0 to count one run. ``name`` is the entry the plant and the
    weights pick (``CFG_ENTRIES``): with ``weights_dtype`` bfloat16 the bf16
    entry ``cfg_episode_bf16``, whose ``plain`` runs ``plain_model``, the
    U-Net with bf16 convs (``models/bf16.py``); with the linear cart-pole
    ``cfg_episode_lmpc``.
    """

    def __init__(self, packed: PackedUnet, schedule: DiffusionSchedule,
                 inputs_stats: NormalizerStats, condition_stats: NormalizerStats, plant: Plant,
                 cost: QuadraticCost, n_steps: int, w: float, n_tail: int, n_candidates: int,
                 selection_cost: QuadraticCost, selection_horizon: int,
                 weights_dtype=torch.float32):
        self.bf16 = is_bf16(weights_dtype)
        self.name = CFG_ENTRIES[plant.name, self.bf16]
        self.lib, self.query = _CFG_LIBS[self.name]
        super().__init__(packed, inputs_stats, condition_stats, plant, cost, n_steps,
                         n_candidates, selection_cost, selection_horizon,
                         *step_coefficients(schedule, n_tail))
        self.plain_model = bf16_conv_copy(self.model) if self.bf16 else self.model
        self.w = float(w)

    @property
    def noise_shape(self) -> Tuple[int, ...]:
        return (self.n_steps, self.n_total + 1, self.n_candidates, self.packed.horizon,
                self.packed.state_dim)

    @torch.no_grad()
    def kernel(self, x0: torch.Tensor, noise: torch.Tensor):
        """Launch ``csrc/cfg_episode.cu`` (its bf16 entry for bf16 weights),
        one cluster of 8 CTAs, on the current stream; raises when the body
        cannot be split over the cluster or no cluster fits on the card."""
        self._check(x0, noise)
        noise_tab = torch.cat([noise[:, 1:], noise[:, :1]], dim=1).contiguous()
        return self._launch(x0, noise_tab, self.w, float(np.float32(1.0 + self.w)))

    @torch.no_grad()
    def plain(self, x0: torch.Tensor, noise: torch.Tensor):
        """The same episode in plain PyTorch, replaying the kernel's
        arithmetic; the chain runs ``plain_model`` on the doubled batch of
        the K candidates (FiLM from mish([t_emb, ctx, bit]) inside its
        ResidualTemporalBlocks)."""
        k = self.n_candidates
        dev = x0.device
        mask2 = torch.cat([torch.zeros((k, 1), device=dev), torch.ones((k, 1), device=dev)])

        def sample(ctx, nz):
            ctx2 = ctx[None].expand(2 * k, ctx.shape[-1])
            u = nz[0]
            for si in range(self.n_total):
                sra, srm, c1, c2, sg = self.coefs[si]
                x2 = torch.cat([u, u], dim=0)
                eps2 = self.plain_model(x2, self.t_eval[si].expand(2 * k), ctx2, mask2)
                recon2 = sra * x2 - srm * eps2
                recon = torch.clamp((1.0 + self.w) * recon2[:k] - self.w * recon2[k:], -1.0, 1.0)
                u = c1 * recon + c2 * u + sg * nz[si + 1]
            return u

        return self._plain_loop(x0, noise, sample)


def cluster_split_features(model: TemporalUnet, x: torch.Tensor, c: torch.Tensor,
                           n_ranks: int = CLUSTER) -> torch.Tensor:
    """``model.features(x, c)`` computed as the cluster episode kernel's
    ``n_ranks`` CTAs compute it (``csrc/unet_body_cluster.cuh``): every conv
    and every GroupNorm per output-channel slice, each slice from the full
    input, one GroupNorm group per slice, then the slices concatenated, which
    is what the CTAs' pushes into each other's shared memory assemble. x (B,
    H, D), c (B, cond_dim) -> (B, H, unet_input_dim). Runs nothing of the
    kernel; the model must pass ``unet_pack.cluster_split``'s checks."""

    def ranks(f, n_out):
        nc = n_out // n_ranks
        return torch.cat([f(slice(r * nc, (r + 1) * nc)) for r in range(n_ranks)], dim=1)

    def conv(m, h):
        return ranks(lambda sl: F.conv1d(h, m.weight[sl], m.bias[sl], m.stride, m.padding),
                     m.out_channels)

    def conv_block(blk, h):  # Conv1d -> GroupNorm -> Mish, one group per rank
        cv, gn = blk.block[0], blk.block[2]
        if gn.num_groups != n_ranks:
            raise ValueError(f"{gn.num_groups} GroupNorm groups, not one per rank of {n_ranks}")
        y = conv(cv, h)
        return ranks(lambda sl: mish(F.group_norm(y[:, sl], 1, gn.weight[sl], gn.bias[sl],
                                                  gn.eps)), cv.out_channels)

    def res_block(rb, h):
        film = rb.cond_mlp(c)
        y = conv_block(rb.blocks[0], h) + film[:, :, None]
        y = conv_block(rb.blocks[1], y)
        res = conv(rb.residual_conv, h) if isinstance(rb.residual_conv, torch.nn.Conv1d) else h
        return y + res

    h = x.transpose(1, 2)
    skips = []
    for rb1, rb2, _, _, down in model.downs:
        h = res_block(rb2, res_block(rb1, h))
        skips.append(h)
        if isinstance(down, torch.nn.Identity):
            continue
        h = conv(down.conv, h)
    h = res_block(model.mid_block2, res_block(model.mid_block1, h))
    for rb1, rb2, _, _, up in model.ups:
        h = res_block(rb2, res_block(rb1, torch.cat([h, skips.pop()], dim=1)))
        ct = up.conv
        h = ranks(lambda sl: F.conv_transpose1d(h, ct.weight[:, sl], ct.bias[sl], ct.stride,
                                                ct.padding), ct.out_channels)
    return conv_block(model.final_conv[0], h).transpose(1, 2)


class FusedDdimEpisode(_Episode):
    """``episode(x0 (dx,), noise (n_steps, K, H, du)) -> (x_track
    (n_steps+1, dx), u_track (n_steps, du), stage_costs (n_steps,))``: a
    distilled student's closed loop, each replan a DDIM chain over ``times``
    from that replan's initial draw.

    ``kernel`` and ``plain`` also return the index of the applied candidate
    at every replan (K where none was chosen). ``launches`` counts kernel
    launches and ``plain_calls`` calls of the plain version; callers reset
    them to 0 to count one run.
    """

    name = "ddim_episode"
    lib = staticmethod(_ddim_lib)
    query = staticmethod(ddim_episode_max_active_clusters)

    def __init__(self, packed: PackedUnet, schedule: DiffusionSchedule, times: Sequence[int],
                 inputs_stats: NormalizerStats, condition_stats: NormalizerStats, plant: Plant,
                 cost: QuadraticCost, n_steps: int, n_candidates: int,
                 selection_cost: QuadraticCost, selection_horizon: int):
        super().__init__(packed, inputs_stats, condition_stats, plant, cost, n_steps,
                         n_candidates, selection_cost, selection_horizon,
                         *ddim_step_coefficients(schedule, times))
        self._sample = make_student_ddim_sampler(schedule, self.model, times)

    @property
    def noise_shape(self) -> Tuple[int, ...]:
        return (self.n_steps, self.n_candidates, self.packed.horizon, self.packed.state_dim)

    @torch.no_grad()
    def kernel(self, x0: torch.Tensor, noise: torch.Tensor):
        """Launch ``csrc/ddim_episode.cu``, one cluster of 8 CTAs, on the
        current stream; raises when the body cannot be split over the
        cluster or no cluster fits on the card."""
        self._check(x0, noise)
        return self._launch(x0, noise.contiguous())

    @torch.no_grad()
    def plain(self, x0: torch.Tensor, noise: torch.Tensor):
        """The same episode in plain PyTorch; each replan's chain is
        ``make_student_ddim_sampler`` over the K candidates, ``TemporalUnet``
        with the context-present bit 1 (FiLM from mish([t_emb, ctx, 1])
        inside its ResidualTemporalBlocks)."""
        k = self.n_candidates
        sample = lambda ctx, u: self._sample(ctx[None].expand(k, ctx.shape[-1]), u)
        return self._plain_loop(x0, noise, sample)


def _episode_packed(model_or_packed: Union[TemporalUnet, PackedUnet], plant: Plant,
                    cost: QuadraticCost, selection_cost, selection_horizon: Optional[int],
                    n_candidates: int, state_to_condition: Optional[Callable],
                    inkernel_noise: bool, device, entries: dict,
                    bf16: bool) -> Tuple[PackedUnet, int, int]:
    """The checks both episode makers make, and the packed U-Net with K and
    the selection horizon. ``entries`` are the kernel's (``CFG_ENTRIES``,
    ``DDIM_ENTRIES``). Raises ``NotImplementedError`` for what the kernels
    cannot run."""
    if (plant.name, bf16) not in entries:
        plants = sorted({name for name, _ in entries})
        if plant.name not in plants:
            raise NotImplementedError(f"the episode kernel runs {plants}, not the plant "
                                      f"'{plant.name}': its step is not written as a device "
                                      "function")
        raise NotImplementedError(f"the episode kernel has no {'bf16' if bf16 else 'float32'} "
                                  f"entry for the plant '{plant.name}'")
    if not isinstance(cost, QuadraticCost):
        raise NotImplementedError("the episode kernel's stage cost is a QuadraticCost")
    if selection_cost is not None and not isinstance(selection_cost, QuadraticCost):
        raise NotImplementedError("the episode kernel scores candidates with a QuadraticCost only, "
                                  f"not {type(selection_cost).__name__}")
    if state_to_condition is not None:
        raise NotImplementedError("state_to_condition inside the episode kernel is not ported")
    if inkernel_noise:
        raise NotImplementedError("inkernel_noise (the in-kernel Philox draw) is not ported; "
                                  "stage the noise")
    packed = packed_on(model_or_packed, device)
    if packed.state_dim != plant.control_dim:
        raise ValueError("the episode denoises control sequences: state_dim must be control_dim")
    if packed.model.context_dim != plant.state_dim:
        raise ValueError("the episode conditions on the plant state: context_dim must be state_dim")
    k = int(n_candidates)
    if k < 1:
        raise ValueError(f"n_candidates must be >= 1, got {n_candidates}")
    sel_h = int(selection_horizon or packed.horizon)
    if not 1 <= sel_h <= packed.horizon:
        raise ValueError(f"selection_horizon must be in 1..{packed.horizon}, got {selection_horizon}")
    return packed, k, sel_h


def make_fused_cfg_episode(model_or_packed: Union[TemporalUnet, PackedUnet],
                           schedule: DiffusionSchedule, inputs_stats: NormalizerStats,
                           condition_stats: NormalizerStats, plant: Plant, cost: QuadraticCost,
                           n_steps: int = 80, w: float = 0.01,
                           n_diffusion_steps_without_noise: int = 5, n_candidates: int = 1,
                           selection_cost=None, selection_horizon: Optional[int] = None,
                           weights_dtype=torch.float32,
                           state_to_condition: Optional[Callable] = None,
                           inkernel_noise: bool = False, device=None) -> FusedCfgEpisode:
    """Build the whole CFG closed loop of one episode on ``device`` (``cuda``
    unless given). Defaults are ``bench.py``'s: 80 replans, T + 5 tail
    steps, w = 0.01, K = 1, float32 weights (``weights_dtype`` bfloat16 is
    ``BENCH_BF16=1``'s). A ``TemporalUnet`` is moved to the device and
    packed. Raises ``NotImplementedError`` for what the kernel cannot run."""
    packed, k, sel_h = _episode_packed(model_or_packed, plant, cost, selection_cost,
                                       selection_horizon, n_candidates, state_to_condition,
                                       inkernel_noise, device, CFG_ENTRIES, is_bf16(weights_dtype))
    return FusedCfgEpisode(packed, schedule, inputs_stats, condition_stats, plant, cost, n_steps,
                           w, n_diffusion_steps_without_noise, k, selection_cost or cost, sel_h,
                           weights_dtype)


def make_fused_ddim_episode(model_or_packed: Union[TemporalUnet, PackedUnet],
                            schedule: DiffusionSchedule, times: Sequence[int],
                            inputs_stats: NormalizerStats, condition_stats: NormalizerStats,
                            plant: Plant, cost: QuadraticCost, n_steps: int = 80,
                            n_candidates: int = 1, selection_cost=None,
                            selection_horizon: Optional[int] = None,
                            weights_dtype=torch.float32, clip_denoised: bool = True,
                            state_to_condition: Optional[Callable] = None,
                            inkernel_noise: bool = False, device=None) -> FusedDdimEpisode:
    """Build a distilled student's whole closed loop of one episode over the
    times grid ``times`` on ``device`` (``cuda`` unless given): 80 replans
    and K = 1 by default, as ``scripts/bench_deep_students.py`` runs it. A
    ``TemporalUnet`` is moved to the device and packed. Raises
    ``NotImplementedError`` for what the kernel cannot run."""
    refuse_unported_ddim_options(weights_dtype, clip_denoised)
    packed, k, sel_h = _episode_packed(model_or_packed, plant, cost, selection_cost,
                                       selection_horizon, n_candidates, state_to_condition,
                                       inkernel_noise, device, DDIM_ENTRIES, False)
    return FusedDdimEpisode(packed, schedule, times, inputs_stats, condition_stats, plant, cost,
                            n_steps, k, selection_cost or cost, sel_h)
