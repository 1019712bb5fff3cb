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
plain version. ``fleet(x0s (N, dx), noise (N, ...))`` runs N independent
episodes, the JAX package's ``jax.vmap`` of the episode (which lifts its
kernel to a grid axis): on a CUDA tensor ONE launch of N clusters, cluster e
running episode e on its own x0, noise and output rows
(``episode_offsets``, the kernels' ``csrc/episode.cuh::episode_offsets``)
and sharing the weights, the tables and the consts, as vmap closes over
them; on the CPU ``plain`` episode by episode. ``episode`` is the fleet of
one on the same kernel code. A fleet larger than the clusters that fit at
once (``cluster.slots``) runs in waves.

Both episode kernels are a thread-block cluster of 8 CTAs that splits the
U-Net body by output channel, one GroupNorm group per CTA
(``csrc/unet_body_cluster.cuh``; two row-sets in the CFG episode, or, for
its panda entries, its two passes in turn on one row-set, and one row-set in
the DDIM episode, each on its plan of shared memory, ``unet_pack.metas``;
the CFG episode refuses to be built where its entry's plan is more than a
block may take, ``fused_denoise.cfg_plan``): they need a card with clusters
(sm_90), and a model whose
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
``QuadraticCost`` for the stage cost, the candidate scorers written there
(a ``QuadraticCost``, or the quadrotor task's ``SafetyFirstCost``, as each
entry's ``Scorer``), the state-to-condition maps written there (the identity,
``control/conditions.py::ConcatFeatures``, or the panda arm's
``PandaContext``, as each entry's ``Condition``), and staged noise but for
the quadrotor's DDIM episode and the panda arm's CFG episode, which also
draw in the kernel. Each
(plant, weights) pair the CFG episode runs is an entry of its own
(``CFG_ENTRIES``): the cart-pole swing-up with float32 weights
(``cfg_episode``) or bfloat16 ones (``bench.py``'s ``BENCH_BF16``: the
kernel's bf16 entry, ``cfg_episode_bf16``, with ``plain`` running the U-Net
of ``models/bf16.py``), the linear cart-pole of the LMPC workload with
float32 weights (``cfg_episode_lmpc``: ``cfg_episode.cu`` compiled for that
plant, ``csrc/cfg_episode_lmpc.cu``, whose A_d and B_d follow dt in the
consts table), all three scoring with a ``QuadraticCost`` and conditioning
on the state; and the scene-conditioned quadrotor student with float32
weights (``cfg_episode_quadrotor``, ``csrc/cfg_episode_quadrotor.cu``: the
quadrotor, its context the state followed by a ``ConcatFeatures``' 12 scene
features, scored by the scene's ``SafetyFirstCost``; the features and the
spheres lie in the consts table, so that one build serves every scene); and
the panda arm's CFG teacher with float32 weights (``cfg_episode_panda``,
``csrc/cfg_episode_panda.cu``: ``PandaRbd``, ``PandaContext`` and a
``QuadraticCost`` scorer, on the plan in turns, ``CFG_PLANS``), whose
``inkernel_noise`` launches ``cfg_episode_panda_draw``: every CTA computes
each replan's x_T and injected draws by Philox4x32-10 counted by (replan x
(n_total + 1) + draw, candidate, row, channel), the JAX kernel's draw index,
and ``plain`` runs on the table that draw produces
(``ops/philox.py::cfg_normal_table``). The
DDIM episode has one entry per plant and weights (``DDIM_ENTRIES``): the
swing-up (``ddim_episode``, a ``QuadraticCost`` scorer, and its bf16 entry
``ddim_episode_bf16``), the quadrotor (``ddim_episode_quadrotor``, ``csrc/
ddim_episode_quadrotor.cu``: its m and inertia follow dt in the consts
table, then the safety-first scorer's constants) and the panda arm
(``ddim_episode_panda``, ``csrc/ddim_episode_panda.cu``: ``PandaRbd``, the
rigid-body plant of ``dynamics/arm.py::panda_rbd_unrolled``, whose tables
follow dt, a ``QuadraticCost`` scorer, and the context of
``make_panda_context``, whose q_ref and FK table follow the plant's; and its
bf16 entry ``ddim_episode_panda_bf16``);
and the quadrotor's bf16 entries
``ddim_episode_quadrotor_bf16`` and ``ddim_episode_quadrotor_draw_bf16``. A bf16 entry reads the conv kernels and the final 1x1 conv
as bf16 and rounds every product's activation operand, and its ``plain``
runs the U-Net of ``models/bf16.py``. Both episodes take
``clip_denoised`` (True by default, as in JAX): False leaves each x0
reconstruction unclipped, a runtime argument of every entry; the clip of
the plans before unnormalizing stays. The quadrotor's entry also
draws its noise in the kernel (``inkernel_noise``, the ``_draw`` entry of
its library): ``episode(x0, seed)`` takes a (2,) int32 seed, as the JAX
package's ``_key_to_seeds`` gives, and every CTA computes each replan's
draw by Philox4x32-10 counted by (replan, candidate, row, channel)
(``csrc/philox.cuh``); its ``plain`` runs the plain episode on the table
that draw produces (``ops/philox.py::normal_table``). At K = 1 the scorer
never runs and its constants are zeros. Any other ``state_to_condition``
runs in ``control/runtime.py::make_closed_loop``; the episode makers refuse
it. Nothing falls back to another path.

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

from ..control.conditions import ConcatFeatures, PandaContext
from ..core.schedules import DiffusionSchedule
from ..data.normalization import NormalizerStats
from ..diffusion.distillation import make_student_ddim_sampler
from ..dynamics.base import Plant, QuadraticCost
from ..dynamics.quadrotor import SafetyFirstCost
from ..models.bf16 import bf16_conv_copy
from ..models.layers import mish
from ..models.temporal_unet import TemporalUnet
from . import _build, philox
from .fused_denoise import cfg_plan, ddim_step_coefficients, is_bf16, step_coefficients
from .unet_pack import CLUSTER, M_LEN, TURNS, PackedUnet, Plan, packed_on

__all__ = ["FusedCfgEpisode", "FusedDdimEpisode", "make_fused_cfg_episode",
           "make_fused_ddim_episode", "affine_consts", "episode_choice", "CFG_ENTRIES",
           "CFG_DRAW_ENTRIES", "CFG_PLANS", "DDIM_ENTRIES", "DDIM_DRAW_ENTRIES", "SCORER_CONSTS",
           "cfg_episode_max_active_clusters", "cfg_episode_bf16_max_active_clusters",
           "cfg_episode_panda_max_active_clusters", "cfg_episode_panda_draw_max_active_clusters",
           "cfg_episode_lmpc_max_active_clusters", "ddim_episode_max_active_clusters",
           "ddim_episode_quadrotor_max_active_clusters", "episode_offsets",
           "ddim_episode_panda_max_active_clusters",
           "cfg_episode_quadrotor_max_active_clusters", "cluster_split_features", "scorer_kind",
           "condition_kind", "CFG_KINDS", "DDIM_CONDITIONS", "CONDITION_CONSTS",
           "CONDITION_EXTRA_DIMS"]

# the entry of each episode kernel for (plant name, bf16 weights): plants written in
# csrc/plants.cuh, each entry with its own library symbols and occupancy query
CFG_ENTRIES = {("cartpole_virtual_swingup", False): "cfg_episode",
               ("cartpole_virtual_swingup", True): "cfg_episode_bf16",
               ("cartpole_lmpc", False): "cfg_episode_lmpc",
               ("quadrotor", False): "cfg_episode_quadrotor",
               ("panda_rbd", False): "cfg_episode_panda"}
# the CFG entry that draws the noise in the kernel, where one exists
CFG_DRAW_ENTRIES = {"cfg_episode_panda": "cfg_episode_panda_draw"}
# the plan of shared memory each CFG entry was compiled for; an entry not named here runs two
# row-sets
CFG_PLANS = {"cfg_episode_panda": TURNS, "cfg_episode_panda_draw": TURNS}
# the kinds of selection cost and of state-to-condition map each CFG entry's Scorer and
# Condition compute (csrc/plants.cuh); an entry not named here scores with a QuadraticCost and
# conditions on the state
CFG_KINDS = {"cfg_episode_quadrotor": ("safety_first", "concat_features"),
             "cfg_episode_panda": ("quadratic", "panda_context")}
# the DDIM episode's entry for each (plant name, bf16 weights), with the kind of selection cost
# its scorer computes (csrc/plants.cuh: QuadScorer, SafetyFirstScorer), and the entry that
# draws the noise in the kernel, where one exists
DDIM_ENTRIES = {("cartpole_virtual_swingup", False): ("ddim_episode", "quadratic"),
                ("cartpole_virtual_swingup", True): ("ddim_episode_bf16", "quadratic"),
                ("quadrotor", False): ("ddim_episode_quadrotor", "safety_first"),
                ("quadrotor", True): ("ddim_episode_quadrotor_bf16", "safety_first"),
                ("panda_rbd", False): ("ddim_episode_panda", "quadratic"),
                ("panda_rbd", True): ("ddim_episode_panda_bf16", "quadratic")}
DDIM_DRAW_ENTRIES = {"ddim_episode_quadrotor": "ddim_episode_quadrotor_draw",
                     "ddim_episode_quadrotor_bf16": "ddim_episode_quadrotor_draw_bf16"}
# the kind of state-to-condition map each DDIM entry's Condition computes; an entry not named
# here conditions on the state
DDIM_CONDITIONS = {"ddim_episode_panda": "panda_context",
                   "ddim_episode_panda_bf16": "panda_context"}
# the constants each scorer reads after the plant's (its N_CONSTS): the safety-first scorer's
# u_hover (4), factor, weight, the 3 spheres' centers and radii
SCORER_CONSTS = {"quadratic": 0, "safety_first": 4 + 2 + 4 * 3}
# the constants each condition map reads after the plant's (its N_CONSTS): the 12 scene
# features of ConcatFeatures<12, 12>; the panda's q_ref (7), its FK's link table (7 x 5) and
# the flange's offset
CONDITION_CONSTS = {"identity": 0, "concat_features": 12, "panda_context": 7 + 35 + 1}
# how much wider than the state each map's context is (DC - DX): the scene's 12 features; the
# end effector's position and velocity
CONDITION_EXTRA_DIMS = {"identity": 0, "concat_features": 12, "panda_context": 6}
_QUERIES = ("consts_len", "plant_dims")


def scorer_kind(cost) -> Optional[str]:
    """The kind of device scorer that computes ``cost`` (a key of
    ``SCORER_CONSTS``), or None where no scorer does."""
    if isinstance(cost, QuadraticCost):
        return "quadratic"
    if isinstance(cost, SafetyFirstCost):
        return cost.scorer
    return None


def condition_kind(state_to_condition) -> Optional[str]:
    """The kind of device map that computes ``state_to_condition`` (a key of
    ``CONDITION_CONSTS``): ``identity`` for None, the map's ``kind`` for a
    ``ConcatFeatures`` or a ``PandaContext``; None where no device map does."""
    if state_to_condition is None:
        return "identity"
    if isinstance(state_to_condition, (ConcatFeatures, PandaContext)):
        return state_to_condition.kind
    return None


@functools.lru_cache(maxsize=None)
def _cfg_lib() -> ctypes.CDLL:
    """The built ``csrc/cfg_episode.cu``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind("cfg_episode", [p, p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, f, f, i, i, p],
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
                       [p, p, p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, f, f, i, i, p],
                       M_LEN, _QUERIES, cluster=CLUSTER, source="cfg_episode")


def cfg_episode_bf16_max_active_clusters(smem_bytes: int) -> int:
    """The same query for the episode kernel's bf16 instantiation."""
    return _build.max_active_clusters(_cfg_bf16_lib(), "cfg_episode_bf16", smem_bytes)


@functools.lru_cache(maxsize=None)
def _cfg_lmpc_lib() -> ctypes.CDLL:
    """The built ``csrc/cfg_episode_lmpc.cu``: the CFG episode for the linear cart-pole."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind("cfg_episode_lmpc",
                       [p, p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, f, f, i, i, p], M_LEN,
                       _QUERIES, cluster=CLUSTER)


def cfg_episode_lmpc_max_active_clusters(smem_bytes: int) -> int:
    """The same query for the linear cart-pole's CFG episode entry."""
    return _build.max_active_clusters(_cfg_lmpc_lib(), "cfg_episode_lmpc", smem_bytes)


@functools.lru_cache(maxsize=None)
def _cfg_quadrotor_lib() -> ctypes.CDLL:
    """The built ``csrc/cfg_episode_quadrotor.cu``: the CFG episode of the
    scene-conditioned quadrotor student, which also answers the width of
    its condition map's context (``condition_dims``)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind("cfg_episode_quadrotor",
                       [p, p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, f, f, i, i, p], M_LEN,
                       (*_QUERIES, "condition_dims"), cluster=CLUSTER)


def cfg_episode_quadrotor_max_active_clusters(smem_bytes: int) -> int:
    """The same query for the scene-conditioned quadrotor's CFG episode entry."""
    return _build.max_active_clusters(_cfg_quadrotor_lib(), "cfg_episode_quadrotor", smem_bytes)


@functools.lru_cache(maxsize=None)
def _cfg_panda_lib(entry: str = "cfg_episode_panda") -> ctypes.CDLL:
    """The built ``csrc/cfg_episode_panda.cu``: the CFG episode of the panda
    arm's teacher on the plan in turns, ``entry`` declared (the draw's takes
    the int32 seed in place of the noise), which also answers the width of
    its condition map's context (``condition_dims``)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind(entry, [p, p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, f, f, i, i, p], M_LEN,
                       (*_QUERIES, "condition_dims"), cluster=CLUSTER, source="cfg_episode_panda")


def cfg_episode_panda_max_active_clusters(smem_bytes: int) -> int:
    """The same query for the panda arm's CFG episode entry."""
    return _build.max_active_clusters(_cfg_panda_lib(), "cfg_episode_panda", smem_bytes)


def cfg_episode_panda_draw_max_active_clusters(smem_bytes: int) -> int:
    """The same query for the panda arm's CFG episode with the in-kernel draw."""
    return _build.max_active_clusters(_cfg_panda_lib("cfg_episode_panda_draw"),
                                      "cfg_episode_panda_draw", smem_bytes)


# each CFG entry's library and occupancy query
_CFG_LIBS = {"cfg_episode": (_cfg_lib, cfg_episode_max_active_clusters),
             "cfg_episode_bf16": (_cfg_bf16_lib, cfg_episode_bf16_max_active_clusters),
             "cfg_episode_lmpc": (_cfg_lmpc_lib, cfg_episode_lmpc_max_active_clusters),
             "cfg_episode_quadrotor": (_cfg_quadrotor_lib,
                                       cfg_episode_quadrotor_max_active_clusters),
             "cfg_episode_panda": (_cfg_panda_lib, cfg_episode_panda_max_active_clusters),
             "cfg_episode_panda_draw": (functools.partial(_cfg_panda_lib, "cfg_episode_panda_draw"),
                                        cfg_episode_panda_draw_max_active_clusters)}


def _ddim_bind(entry: str, source: str, queries=_QUERIES) -> ctypes.CDLL:
    """``_build.bind`` of a DDIM episode ``entry`` of ``csrc/<source>.cu``; a bf16 entry takes
    the bf16 copy of the weights second."""
    p, i = ctypes.c_void_p, ctypes.c_int
    weights = [p, p] if entry.endswith("_bf16") else [p]
    return _build.bind(entry, [*weights, p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p], M_LEN,
                       queries, cluster=CLUSTER, source=source)


@functools.lru_cache(maxsize=None)
def _ddim_lib(entry: str = "ddim_episode") -> ctypes.CDLL:
    """The built ``csrc/ddim_episode.cu``, ``entry`` (``ddim_episode`` or
    ``ddim_episode_bf16``) declared."""
    return _ddim_bind(entry, "ddim_episode")


def ddim_episode_max_active_clusters(smem_bytes: int, entry: str = "ddim_episode") -> int:
    """The same query for the DDIM episode kernel's cluster (``entry``: the
    swing-up's fp32 or bf16 entry)."""
    return _build.max_active_clusters(_ddim_lib(entry), entry, smem_bytes)


@functools.lru_cache(maxsize=None)
def _ddim_quadrotor_lib(entry: str = "ddim_episode_quadrotor") -> ctypes.CDLL:
    """The built ``csrc/ddim_episode_quadrotor.cu``: the DDIM episode for the
    quadrotor, ``entry`` declared (``ddim_episode_quadrotor``, or
    ``ddim_episode_quadrotor_draw``, which takes the int32 seed in place of
    the noise); the bf16 entry of either, ``<entry>_bf16``, is
    ``csrc/ddim_episode_quadrotor_bf16.cu``'s."""
    source = "ddim_episode_quadrotor_bf16" if entry.endswith("_bf16") else "ddim_episode_quadrotor"
    return _ddim_bind(entry, source)


def ddim_episode_quadrotor_max_active_clusters(smem_bytes: int,
                                               entry: str = "ddim_episode_quadrotor") -> int:
    """The same query for the quadrotor's DDIM episode entry ``entry`` (fp32
    or bf16, staged or drawing)."""
    return _build.max_active_clusters(_ddim_quadrotor_lib(entry), entry, smem_bytes)


@functools.lru_cache(maxsize=None)
def _ddim_panda_lib(entry: str = "ddim_episode_panda") -> ctypes.CDLL:
    """The built ``csrc/ddim_episode_panda.cu``: the DDIM episode for the
    panda arm, ``entry`` declared (``ddim_episode_panda`` or its bf16 entry
    ``ddim_episode_panda_bf16``), which also answers the width of its
    condition map's context (``condition_dims``)."""
    return _ddim_bind(entry, "ddim_episode_panda", (*_QUERIES, "condition_dims"))


def ddim_episode_panda_max_active_clusters(smem_bytes: int,
                                           entry: str = "ddim_episode_panda") -> int:
    """The same query for the panda arm's DDIM episode entry (fp32 or bf16)."""
    return _build.max_active_clusters(_ddim_panda_lib(entry), entry, smem_bytes)


# each DDIM entry's library and occupancy query
_DDIM_LIBS = {
    "ddim_episode": (_ddim_lib, ddim_episode_max_active_clusters),
    "ddim_episode_bf16": (functools.partial(_ddim_lib, "ddim_episode_bf16"),
                          functools.partial(ddim_episode_max_active_clusters,
                                            entry="ddim_episode_bf16")),
    "ddim_episode_quadrotor": (_ddim_quadrotor_lib, ddim_episode_quadrotor_max_active_clusters),
    **{entry: (functools.partial(_ddim_quadrotor_lib, entry),
               functools.partial(ddim_episode_quadrotor_max_active_clusters, entry=entry))
       for entry in ("ddim_episode_quadrotor_draw", "ddim_episode_quadrotor_bf16",
                     "ddim_episode_quadrotor_draw_bf16")},
    "ddim_episode_panda": (_ddim_panda_lib, ddim_episode_panda_max_active_clusters),
    "ddim_episode_panda_bf16": (functools.partial(_ddim_panda_lib, "ddim_episode_panda_bf16"),
                                functools.partial(ddim_episode_panda_max_active_clusters,
                                                  entry="ddim_episode_panda_bf16"))}


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


def episode_offsets(e: int, n_steps: int, dx: int, du: int, noise_len: int) -> dict:
    """Where episode ``e`` of a fleet reads and writes, in elements of the
    flat buffers the episode kernels take (``csrc/episode.cuh::
    episode_offsets``, the same formula): ``x0`` (dx per episode), ``noise``
    (``noise_len``: one episode's staged table, or its 2 seed words),
    ``x_track`` ((n_steps + 1) dx), ``u_track`` (n_steps du), ``costs`` and
    ``chosen`` (n_steps). Cluster e of the grid runs episode e."""
    n = int(n_steps)
    return {"x0": e * dx, "noise": e * noise_len, "x_track": e * (n + 1) * dx,
            "u_track": e * n * du, "costs": e * n, "chosen": e * n}


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
    plan: Plan = 1  # its plan of shared memory (unet_pack.metas): the row-sets, or TURNS
    inkernel_noise = False  # the entry draws its noise in the kernel from a (2,) int32 seed
    clip_denoised = True  # clip each x0 reconstruction to [-1, 1] (the entry's `clip` argument)

    scorer = "quadratic"  # the kind of selection cost the entry's scorer computes

    def __init__(self, packed: PackedUnet, inputs_stats: NormalizerStats,
                 condition_stats: NormalizerStats, plant: Plant, cost: QuadraticCost,
                 n_steps: int, n_candidates: int, selection_cost, selection_horizon: int,
                 coefs: np.ndarray, t_eval: np.ndarray, state_to_condition=None):
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
        # the condition map (the identity unless given) and the context's width
        self.state_to_condition = (state_to_condition.to(device) if state_to_condition is not None
                                   else None)
        self.context_dim = dc = packed.model.context_dim
        cond_consts = np.float32(getattr(state_to_condition, "device_consts", ()))
        cn_shift, cn_scale, _, _ = affine_consts(condition_stats, dc)
        _, _, un_shift, un_scale = affine_consts(inputs_stats, du)
        vec = lambda t, n: np.broadcast_to(np.asarray(t.cpu(), np.float32).reshape(-1), (n,))
        # the scorer's own constants; zeros at K = 1, where it never runs
        scored = self.n_candidates > 1 or scorer_kind(selection_cost) == self.scorer
        sc = (np.float32(getattr(selection_cost, "device_consts", ())) if scored
              else np.zeros(SCORER_CONSTS[self.scorer], np.float32))
        if sc.size != SCORER_CONSTS[self.scorer]:
            raise ValueError(f"the {self.scorer} scorer reads {SCORER_CONSTS[self.scorer]} "
                             f"constants, the selection cost lays out {sc.size}")
        self.consts = torch.from_numpy(np.concatenate([
            cn_shift, cn_scale, un_shift, un_scale,
            vec(cost.q_diag, dx), vec(cost.r, du),
            vec(selection_cost.q_diag, dx), vec(selection_cost.r, du), vec(selection_cost.p_diag, dx),
            np.float32([plant.dt]), np.float32(plant.device_consts), cond_consts,
            sc]).astype(np.float32)).to(device)
        self.cost, self.selection_cost = cost.to(device), selection_cost.to(device)
        # its plan: the meta table the kernel reads and its shared memory per CTA, checked where
        # the kernel would launch (ClusterLaunch.require_fit)
        self.meta = packed.metas[self.plan]
        self.smem_bytes = packed.episode_smem_bytes(self.n_candidates, self.plan)
        self.launches = 0
        self.plain_calls = 0
        self.plain_scores: Optional[torch.Tensor] = None
        self.last_chosen: Optional[torch.Tensor] = None

    @property
    def weights(self) -> torch.Tensor:
        """The buffer the kernel reads: the packed weights with the body's
        conv kernels rank-major."""
        return self.cluster.weights

    @property
    def noise_shape(self) -> Tuple[int, ...]:
        """The episode's second argument: the staged noise (``table_shape``),
        or the (2,) int32 seed of the in-kernel draw."""
        return (2,) if self.inkernel_noise else self.table_shape

    def _check(self, x0: torch.Tensor, noise: torch.Tensor, fleet: bool = False) -> None:
        """One episode's x0 (dx,) and noise (``noise_shape``), or with
        ``fleet`` N episodes' (N, dx) and (N, *noise_shape), N >= 1 and the
        same in both; float32 (the seed int32), on one device."""
        lead = ()
        if fleet:
            n = x0.shape[0] if x0.dim() == 2 else 0
            if n < 1 or noise.dim() == 0 or noise.shape[0] != n:
                raise ValueError(f"a fleet takes x0s (N, {self.plant.state_dim}) and noise (N, "
                                 f"...) with one N >= 1, got {tuple(x0.shape)} and "
                                 f"{tuple(noise.shape)}")
            lead = (n,)
        if tuple(x0.shape) != lead + (self.plant.state_dim,) or x0.dtype != torch.float32:
            raise ValueError(f"x0 must be {lead + (self.plant.state_dim,)} float32, got "
                             f"{tuple(x0.shape)} {x0.dtype}")
        what, dtype = ("the seed", torch.int32) if self.inkernel_noise else ("noise", torch.float32)
        if tuple(noise.shape) != lead + self.noise_shape or noise.dtype != dtype:
            raise ValueError(f"{what} must be {lead + self.noise_shape} {dtype}, got "
                             f"{tuple(noise.shape)} {noise.dtype}")
        if x0.device != noise.device:
            raise ValueError(f"x0 and {what} must lie on one device")

    def episode(self, x0: torch.Tensor, noise: torch.Tensor):
        out = self.plain(x0, noise) if x0.device.type == "cpu" else self.kernel(x0, noise)
        self.last_chosen = out[3]  # the applied candidate of every replan
        return out[:3]

    __call__ = episode

    def fleet(self, x0s: torch.Tensor, noise: torch.Tensor):
        """N independent episodes, x0s (N, dx) and noise (N, *noise_shape)
        (the seeds (N, 2) with ``inkernel_noise``) -> (x_tracks (N, n_steps+1,
        dx), u_tracks (N, n_steps, du), stage_costs (N, n_steps)), the JAX
        package's ``jax.vmap`` of ``episode``: one launch of N clusters on a
        CUDA tensor (``fleet_kernel``), ``plain`` episode by episode on the
        CPU (``plain_scores`` then holds the last episode's). Sets
        ``last_chosen`` (N, n_steps)."""
        if x0s.device.type == "cpu":
            self._check(x0s, noise, fleet=True)
            runs = [self.plain(x0s[e], noise[e]) for e in range(x0s.shape[0])]
            out = tuple(torch.stack(parts) for parts in zip(*runs))
        else:
            out = self.fleet_kernel(x0s, noise)
        self.last_chosen = out[3]
        return out[:3]

    @torch.no_grad()
    def kernel(self, x0: torch.Tensor, noise: torch.Tensor):
        """One episode through the entry's kernel: the fleet of one, one
        cluster of 8 CTAs, on the current stream; raises when the body cannot
        be split over the cluster, the entry's plan at this K is more than a
        block may take or no cluster fits on the card."""
        self._check(x0, noise)
        out = self._launch(x0[None], self._noise_tab(noise[None]), *self._scalars())
        return tuple(o[0] for o in out)

    @torch.no_grad()
    def fleet_kernel(self, x0s: torch.Tensor, noise: torch.Tensor):
        """N episodes through the entry's kernel in ONE launch of N clusters
        on the current stream, each on its own x0 and noise; raises as
        ``kernel`` does and never falls back."""
        self._check(x0s, noise, fleet=True)
        return self._launch(x0s, self._noise_tab(noise), *self._scalars())

    def _scalars(self) -> tuple:
        """The entry's launch arguments after n_steps, n_total, K and sel_h."""
        return ()

    def _noise_tab(self, noise: torch.Tensor) -> torch.Tensor:
        """N episodes' noise (N, *noise_shape) in the kernel's layout."""
        return noise.contiguous()

    def _launch(self, x0s: torch.Tensor, noise_tab: torch.Tensor, *scalars,
                lib: Optional[ctypes.CDLL] = None):
        """Checks the library (the port's ``lib()`` unless another build of
        ``<name>.cu`` is given, as the scripts that time edited copies give
        theirs) against this wrapper, asks once whether its cluster fits,
        allocates the outputs and launches ``<name>_launch`` on the current
        stream: N clusters of 8 CTAs for x0s (N, dx) and noise_tab (N, ...)
        in the kernel's layout. Returns (x_tracks (N, n_steps + 1, dx),
        u_tracks (N, n_steps, du), costs (N, n_steps), chosen (N,
        n_steps))."""
        if not x0s.is_cuda or x0s.device != self.packed.weights.device:
            raise ValueError(f"the {self.name} kernel takes tensors on the packed weights' CUDA device")
        if x0s.dim() != 2 or x0s.shape[0] < 1 or noise_tab.shape[0] != x0s.shape[0]:
            raise ValueError(f"the {self.name} kernel takes x0s (N, dx) and noise (N, ...), "
                             f"N >= 1, got {tuple(x0s.shape)} and {tuple(noise_tab.shape)}")
        weights = [self.weights] + ([self.cluster.weights_bf16] if self.bf16 else [])
        lib = self.lib() if lib is None else lib
        dev, dx, du = x0s.device, self.plant.state_dim, self.plant.control_dim
        if getattr(lib, f"{self.name}_plant_dims")() != 100 * dx + du:
            raise RuntimeError(f"{self.name}.cu was built for another plant")
        if getattr(lib, f"{self.name}_consts_len")() != self.consts.numel():
            raise RuntimeError(f"{self.name}.cu and fused_episode.py disagree on the consts layout")
        if (hasattr(lib, f"{self.name}_condition_dims")
                and getattr(lib, f"{self.name}_condition_dims")() != self.context_dim):
            raise RuntimeError(f"{self.name}.cu maps the state to another context width than "
                               f"{self.context_dim}")
        self.cluster.require_fit(self.smem_bytes, x0s.device)
        n = x0s.shape[0]
        x_track = torch.empty((n, self.n_steps + 1, dx), dtype=torch.float32, device=dev)
        u_track = torch.empty((n, self.n_steps, du), dtype=torch.float32, device=dev)
        costs = torch.empty((n, self.n_steps), dtype=torch.float32, device=dev)
        chosen = torch.empty((n, self.n_steps), dtype=torch.int32, device=dev)
        x0s = x0s.contiguous()
        _build.launch(
            lib, self.name,
            *(wt.data_ptr() for wt in weights), self.meta.data_ptr(), self.smem_bytes,
            self.t_embs.data_ptr(), noise_tab.data_ptr(), self.coefs.data_ptr(),
            self.consts.data_ptr(), x0s.data_ptr(), x_track.data_ptr(), u_track.data_ptr(),
            costs.data_ptr(), chosen.data_ptr(), self.n_steps, self.n_total, self.n_candidates,
            self.selection_horizon, *scalars, int(self.clip_denoised), n,
            torch.cuda.current_stream(dev).cuda_stream)
        self.launches += 1
        return x_track, u_track, costs, chosen

    def _plain_loop(self, x0: torch.Tensor, noise: torch.Tensor, sample: Callable):
        """The plain episode around ``sample(ctx (dc,), noise_of_replan) ->
        u_norm (K, H, du)``, the chain of one replan in the kernel's
        arithmetic: the condition map, the affine normalize, the chain, the clip and
        unnormalize, the candidate rollouts and the first-min choice, the
        unrolled stage cost and the plant step. At K > 1 it keeps every
        replan's candidate scores in ``plain_scores`` (n_steps, K), which
        tell a near-tie from a real choice. The caller has checked the
        arguments."""
        self.plain_calls += 1
        c = self.consts
        dx, du, dc = self.plant.state_dim, self.plant.control_dim, self.context_dim
        cn_shift, cn_scale = c[:dc], c[dc:2 * dc]
        un_shift, un_scale = c[2 * dc:2 * dc + du], c[2 * dc + du:2 * dc + 2 * du]
        to_cond = self.state_to_condition or (lambda v: v)
        k, horizon, dev = self.n_candidates, self.packed.horizon, x0.device
        q = [float(v) for v in self.cost.q_diag.reshape(-1)]
        r = [float(v) for v in self.cost.r.reshape(-1).expand(du)]
        x = x0
        xs, us, stages, chosen, scores = [x0], [], [], [], []
        for step in range(self.n_steps):
            u = sample((to_cond(x) - cn_shift) * cn_scale, noise[step])
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
    With ``inkernel_noise`` (the panda entry's) the second argument is a (2,)
    int32 seed and the kernel draws every x_T and injected normal itself
    (``ops/philox.py``); ``noise_table(seed)`` is that draw staged.

    ``kernel`` and ``plain`` also return the index of the applied candidate
    at every replan (K where none was chosen). ``launches`` counts kernel
    launches and ``plain_calls`` calls of the plain version; callers reset
    them to 0 to count one run. ``name`` is the entry the plant and the
    weights pick (``CFG_ENTRIES``): with ``weights_dtype`` bfloat16 the bf16
    entry ``cfg_episode_bf16``, whose ``plain`` runs ``plain_model``, the
    U-Net with bf16 convs (``models/bf16.py``); with the linear cart-pole
    ``cfg_episode_lmpc``; with the quadrotor ``cfg_episode_quadrotor``,
    whose context is ``state_to_condition(x)``, a ``ConcatFeatures``; with
    the panda arm ``cfg_episode_panda`` (``cfg_episode_panda_draw`` with
    ``inkernel_noise``), whose context is a ``PandaContext``. ``plan`` is
    the entry's plan of shared memory (``CFG_PLANS``: two row-sets; the
    panda entries' in turns); where it is more than a block may take the
    episode refuses to be built (``cfg_plan``'s ``ValueError``).
    ``clip_denoised`` False leaves the CFG reconstruction unclipped.
    """

    def __init__(self, packed: PackedUnet, schedule: DiffusionSchedule,
                 inputs_stats: NormalizerStats, condition_stats: NormalizerStats, plant: Plant,
                 cost: QuadraticCost, n_steps: int, w: float, n_tail: int, n_candidates: int,
                 selection_cost: QuadraticCost, selection_horizon: int,
                 weights_dtype=torch.float32, state_to_condition=None,
                 inkernel_noise: bool = False, clip_denoised: bool = True):
        self.bf16 = is_bf16(weights_dtype)
        self.clip_denoised = bool(clip_denoised)
        entry = CFG_ENTRIES[plant.name, self.bf16]
        self.scorer = CFG_KINDS.get(entry, ("quadratic",))[0]
        self.inkernel_noise = bool(inkernel_noise)
        self.name = CFG_DRAW_ENTRIES[entry] if self.inkernel_noise else entry
        self.lib, self.query = _CFG_LIBS[self.name]
        self.plan, _ = cfg_plan(lambda plan: packed.episode_smem_bytes(n_candidates, plan),
                                f"{self.name} kernel at K = {n_candidates}",
                                (CFG_PLANS.get(self.name, 2),))
        super().__init__(packed, inputs_stats, condition_stats, plant, cost, n_steps,
                         n_candidates, selection_cost, selection_horizon,
                         *step_coefficients(schedule, n_tail), state_to_condition)
        self.plain_model = bf16_conv_copy(self.model) if self.bf16 else self.model
        self.w = float(w)

    @property
    def table_shape(self) -> Tuple[int, ...]:
        """The staged noise of one episode: (n_steps, n_total + 1, K, H, du)."""
        return (self.n_steps, self.n_total + 1, self.n_candidates, self.packed.horizon,
                self.packed.state_dim)

    def noise_table(self, seed: torch.Tensor) -> torch.Tensor:
        """The in-kernel draw of an episode seeded ``seed``, staged
        (``table_shape``), on the seed's device (``ops/philox.py``)."""
        return philox.cfg_normal_table(seed, self.n_steps, self.n_total, self.n_candidates,
                                       self.packed.horizon, self.packed.state_dim)

    def _scalars(self) -> tuple:
        """w and 1 + w, the CFG lines' weights."""
        return self.w, float(np.float32(1.0 + self.w))

    def _noise_tab(self, noise: torch.Tensor) -> torch.Tensor:
        """The staged noise (N, n_steps, n_total + 1, K, H, du) with each
        replan's x_T moved after its injected draws, the kernel's order (the
        seeds as they are). The kernel is the entry's: ``csrc/cfg_episode.cu``,
        its bf16 entry for bf16 weights, ``csrc/cfg_episode_lmpc.cu``,
        ``csrc/cfg_episode_quadrotor.cu`` or ``csrc/cfg_episode_panda.cu``."""
        if self.inkernel_noise:
            return noise.contiguous()
        return torch.cat([noise[:, :, 1:], noise[:, :, :1]], dim=2).contiguous()

    @torch.no_grad()
    def plain(self, x0: torch.Tensor, noise: torch.Tensor):
        """The same episode in plain PyTorch, replaying the kernel's
        arithmetic; the chain runs ``plain_model`` on the doubled batch of
        the K candidates (FiLM from mish([t_emb, ctx, bit]) inside its
        ResidualTemporalBlocks). With ``inkernel_noise`` on
        ``noise_table(seed)``."""
        self._check(x0, noise)
        if self.inkernel_noise:
            noise = self.noise_table(noise)
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
                recon = (1.0 + self.w) * recon2[:k] - self.w * recon2[k:]
                if self.clip_denoised:
                    recon = torch.clamp(recon, -1.0, 1.0)
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
    from that replan's initial draw. With ``inkernel_noise`` the second
    argument is a (2,) int32 seed and the kernel draws each replan's noise
    itself (``ops/philox.py``); ``noise_table(seed)`` is that draw staged.

    ``kernel`` and ``plain`` also return the index of the applied candidate
    at every replan (K where none was chosen). ``launches`` counts kernel
    launches and ``plain_calls`` calls of the plain version; callers reset
    them to 0 to count one run. ``name`` is the entry the plant, the weights
    and the draw pick (``DDIM_ENTRIES``, ``DDIM_DRAW_ENTRIES``): with
    ``weights_dtype`` bfloat16 the plant's bf16 entry, whose ``plain`` runs
    ``plain_model``, the U-Net with bf16 convs (``models/bf16.py``). The
    kernel is the entry's: ``csrc/ddim_episode.cu``,
    ``csrc/ddim_episode_quadrotor.cu`` or ``csrc/ddim_episode_panda.cu``.
    ``clip_denoised`` False leaves each reconstruction unclipped.
    """

    def __init__(self, packed: PackedUnet, schedule: DiffusionSchedule, times: Sequence[int],
                 inputs_stats: NormalizerStats, condition_stats: NormalizerStats, plant: Plant,
                 cost: QuadraticCost, n_steps: int, n_candidates: int, selection_cost,
                 selection_horizon: int, inkernel_noise: bool = False, state_to_condition=None,
                 weights_dtype=torch.float32, clip_denoised: bool = True):
        self.bf16 = is_bf16(weights_dtype)
        self.clip_denoised = bool(clip_denoised)
        entry, self.scorer = DDIM_ENTRIES[plant.name, self.bf16]
        self.inkernel_noise = bool(inkernel_noise)
        self.name = DDIM_DRAW_ENTRIES[entry] if self.inkernel_noise else entry
        self.lib, self.query = _DDIM_LIBS[self.name]
        super().__init__(packed, inputs_stats, condition_stats, plant, cost, n_steps,
                         n_candidates, selection_cost, selection_horizon,
                         *ddim_step_coefficients(schedule, times), state_to_condition)
        self.plain_model = bf16_conv_copy(self.model) if self.bf16 else self.model
        self._sample = make_student_ddim_sampler(schedule, self.plain_model, times,
                                                 self.clip_denoised)

    @property
    def table_shape(self) -> Tuple[int, ...]:
        """The staged noise of one episode: (n_steps, K, H, du)."""
        return (self.n_steps, self.n_candidates, self.packed.horizon, self.packed.state_dim)

    def noise_table(self, seed: torch.Tensor) -> torch.Tensor:
        """The in-kernel draw of an episode seeded ``seed``, staged (n_steps,
        K, H, du), on the seed's device (``ops/philox.py``)."""
        return philox.normal_table(seed, self.table_shape)

    @torch.no_grad()
    def plain(self, x0: torch.Tensor, noise: torch.Tensor):
        """The same episode in plain PyTorch; each replan's chain is
        ``make_student_ddim_sampler`` over the K candidates, ``plain_model``
        with the context-present bit 1 (FiLM from mish([t_emb, ctx, 1])
        inside its ResidualTemporalBlocks). With ``inkernel_noise`` on
        ``noise_table(seed)``."""
        self._check(x0, noise)
        k = self.n_candidates
        sample = lambda ctx, u: self._sample(ctx[None].expand(k, ctx.shape[-1]), u)
        return self._plain_loop(x0, self.noise_table(noise) if self.inkernel_noise else noise,
                                sample)


def _episode_packed(model_or_packed: Union[TemporalUnet, PackedUnet], plant: Plant,
                    cost: QuadraticCost, selection_cost, selection_horizon: Optional[int],
                    n_candidates: int, state_to_condition: Optional[Callable],
                    inkernel_noise: bool, device, plants: Sequence[str], entry: Optional[str],
                    scorer: str, can_draw: bool, weights: str = "float32",
                    condition: str = "identity") -> Tuple[PackedUnet, int, int]:
    """The checks both episode makers make, and the packed U-Net with K and
    the selection horizon. ``plants`` are those the kernel has entries for,
    ``entry`` the one for ``plant`` (None when there is none for its
    weights), ``scorer`` the kind of selection cost that entry scores with,
    ``can_draw`` whether it has an in-kernel draw, ``weights`` the weights'
    type asked for, ``condition`` the kind of state-to-condition map the
    entry runs. Raises ``NotImplementedError`` for what the kernels cannot
    run, and ``ValueError`` where the model's widths do not fit the entry."""
    if entry is None:
        if plant.name not in plants:
            raise NotImplementedError(f"the episode kernel runs {sorted(plants)}, not the plant "
                                      f"'{plant.name}': its step is not written as a device "
                                      "function")
        raise NotImplementedError(f"the episode kernel has no {weights} entry for the plant "
                                  f"'{plant.name}'")
    if not isinstance(cost, QuadraticCost):
        raise NotImplementedError("the episode kernel's stage cost is a QuadraticCost")
    kind = scorer_kind(selection_cost if selection_cost is not None else cost)
    if kind is None:
        raise NotImplementedError("the episode kernel scores candidates with a QuadraticCost or "
                                  "the quadrotor task's SafetyFirstCost only, not "
                                  f"{type(selection_cost).__name__}")
    if kind != scorer and int(n_candidates) > 1:
        raise NotImplementedError(f"the episode kernel's entry for the plant '{plant.name}' "
                                  f"scores candidates with a {scorer} cost, not a {kind} one")
    cond = condition_kind(state_to_condition)
    if cond is None:
        raise NotImplementedError("the episode kernel runs the identity state_to_condition, a "
                                  "ConcatFeatures or a PandaContext (control/conditions.py) only, "
                                  f"not {type(state_to_condition).__name__}")
    if cond != condition:
        raise NotImplementedError(f"the episode kernel's entry for the plant '{plant.name}' maps "
                                  f"the state to its condition by {condition}, not {cond}")
    n_cond = len(getattr(state_to_condition, "device_consts", ()))
    if n_cond != CONDITION_CONSTS[condition]:
        raise ValueError(f"the {condition} map of the entry for the plant '{plant.name}' reads "
                         f"{CONDITION_CONSTS[condition]} constants, the map lays out {n_cond}")
    if inkernel_noise and not can_draw:
        raise NotImplementedError(f"inkernel_noise (the in-kernel Philox draw) is not ported for "
                                  f"the {entry} entry; stage the noise")
    packed = packed_on(model_or_packed, device)
    if packed.state_dim != plant.control_dim:
        raise ValueError("the episode denoises control sequences: state_dim must be control_dim")
    dc = plant.state_dim + CONDITION_EXTRA_DIMS[condition]  # the entry's Condition's DC
    if packed.model.context_dim != dc:
        raise ValueError(f"the episode conditions on the {condition} map of the plant state: "
                         f"context_dim must be {dc}, got {packed.model.context_dim}")
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
                           inkernel_noise: bool = False, clip_denoised: bool = True,
                           device=None) -> FusedCfgEpisode:
    """Build the whole CFG closed loop of one episode on ``device`` (``cuda``
    unless given). Defaults are ``bench.py``'s: 80 replans, T + 5 tail
    steps, w = 0.01, K = 1, float32 weights (``weights_dtype`` bfloat16 is
    ``BENCH_BF16=1``'s). A ``TemporalUnet`` is moved to the device and
    packed. The quadrotor's entry takes its ``state_to_condition`` as a
    ``ConcatFeatures`` and its ``selection_cost`` as a ``SafetyFirstCost``;
    a scene is their constants. The panda arm's entry takes a
    ``PandaContext``, and ``inkernel_noise`` (its entry only) makes the
    episode take a (2,) int32 seed (``ops/philox.py::seed_from_generator``)
    in place of staged noise. ``clip_denoised`` False leaves the CFG
    reconstruction unclipped. Raises ``NotImplementedError`` for what the
    kernel cannot run, and ``ValueError`` where the entry's plan does not
    fit one block at this K."""
    entry = CFG_ENTRIES.get((plant.name, is_bf16(weights_dtype)))
    scorer, condition = CFG_KINDS.get(entry, ("quadratic", "identity"))
    packed, k, sel_h = _episode_packed(model_or_packed, plant, cost, selection_cost,
                                       selection_horizon, n_candidates, state_to_condition,
                                       inkernel_noise, device, {p for p, _ in CFG_ENTRIES},
                                       entry, scorer, entry in CFG_DRAW_ENTRIES,
                                       "bf16" if is_bf16(weights_dtype) else "float32", condition)
    return FusedCfgEpisode(packed, schedule, inputs_stats, condition_stats, plant, cost, n_steps,
                           w, n_diffusion_steps_without_noise, k, selection_cost or cost, sel_h,
                           weights_dtype, state_to_condition, inkernel_noise, clip_denoised)


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
    ``TemporalUnet`` is moved to the device and packed. ``weights_dtype``
    bfloat16 runs the plant's bf16 entry (every plant has one);
    ``clip_denoised`` False leaves each reconstruction unclipped.
    ``inkernel_noise`` (the quadrotor's entry only) makes the episode take a
    (2,) int32 seed (``ops/philox.py::seed_from_generator``) in place of
    staged noise. Raises ``NotImplementedError`` for what the kernel cannot
    run."""
    bf16 = is_bf16(weights_dtype)
    entry, scorer = DDIM_ENTRIES.get((plant.name, bf16), (None, None))
    packed, k, sel_h = _episode_packed(model_or_packed, plant, cost, selection_cost,
                                       selection_horizon, n_candidates, state_to_condition,
                                       inkernel_noise, device, {p for p, _ in DDIM_ENTRIES},
                                       entry, scorer, entry in DDIM_DRAW_ENTRIES,
                                       "bf16" if bf16 else "float32",
                                       DDIM_CONDITIONS.get(entry, "identity"))
    return FusedDdimEpisode(packed, schedule, times, inputs_stats, condition_stats, plant, cost,
                            n_steps, k, selection_cost or cost, sel_h, inkernel_noise,
                            state_to_condition, weights_dtype, clip_denoised)
