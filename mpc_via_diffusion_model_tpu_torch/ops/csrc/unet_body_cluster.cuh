// The conv backbone of the temporal U-Net split over a thread-block cluster of CLUSTER CTAs,
// by output channel: the body of every kernel that runs the U-Net, cfg_episode.cu and
// cfg_chain.cu (two row-sets, NB = 2), and fused_unet.cu, ddim_chain.cu and ddim_episode.cu
// (one, NB = 1). fused_conv.cu, one conv block on no model path, runs its own tensor-core
// tile, one CTA per GroupNorm group and batch chunk, and none of this file.
//
// Port of the U-Net body that mpc_via_diffusion_model_tpu/ops/fused_unet.py::build_unet_ops
// traces into every Pallas kernel of the JAX package, on unet_body.cuh's layout and meta
// table, cut over the cluster:
// - Every conv of the body (the two k5 convs and the 1x1 residual conv of each
//   ResidualTemporalBlock, the k3 s2 downsample, the k4 s2 transposed upsample and the final
//   Conv1dBlock's conv) is split by output channel: rank r computes the channels
//   [r * cout / CLUSTER, (r + 1) * cout / CLUSTER) of every row of both row-sets.
// - The flagship has 8 GroupNorm groups at every width (models/layers.py,
//   group_norm_n_groups), and CLUSTER = 8, so a rank's channels are exactly one group: its
//   GroupNorm statistics, the Mish and the FiLM bias of its channels need nothing from
//   another CTA. ops/unet_pack.py::cluster_split refuses a model where this does not hold.
// - Every CTA keeps the full activations, skips and halos in its own shared memory, with
//   unet_body.cuh's layout and ops/unet_pack.py's plan. When a rank's slice of an
//   activation is final (after GroupNorm, Mish and FiLM in a block's first half; after the
//   residual add in its second; the downsample's and upsample's conv outputs), the rank
//   stores it into the same buffer of every CTA of the cluster (distributed shared
//   memory), and one cluster barrier makes it visible: two barriers per residual block, one
//   per down- or upsample, one for the final block. The skip copies, the concatenation and
//   the halo zeroing read only replicated data, so they stay local.
// - The rule that keeps the pushes race-free: a rank stores into a buffer of another CTA
//   only when no CTA reads that buffer between the last cluster barrier and the next one.
//   Three buffers rotate: a residual block reads `cur` and writes the other two, and the
//   block's output becomes `cur`. After the up path's concatenation, which reads `cur`, the
//   next block's scratch is the third buffer, not `cur`.
//
// Inside a CTA, a conv's share is rows x (cout / CLUSTER) outputs with a reduction over
// ks * cin inputs: 256 outputs at every level of the flagship, for NT = 512 threads. An item
// is CL_RPT consecutive rows of one channel; its reduction is split over S neighbouring
// lanes (the largest power of two, at most CL_SPLIT, with items * S <= NT), each lane
// taking every S-th input, and summed with shuffles that halve the rows a lane holds at each
// step (reduce_store). Neighbouring items are neighbouring channels of the same rows, so a
// warp's lanes read S neighbouring activations (no bank conflict, shared by the items).
// 8 rows per item is the cut that measured fastest on the H100 against 1, 4 and 16 rows and
// against one lane per item (PERF.md; scripts/episode_recut.py builds and times each). What
// bounds it there is not the FMAs: every lane's FMA needs a shared-memory load of its
// activation, every CL_RPT FMAs a weight from L2, and a pass has about 30 layers, each
// followed by block and cluster barriers.
// Weights stay in device memory and are served from L2 through __ldg, as in unet_body.cuh,
// and each rank reads an eighth of them; but the kernel gets the conv kernels rank-major
// (ops/unet_pack.py::cluster_weights): a conv's (ks * cin, cout) kernel at its usual offset
// holds (CLUSTER, ks * cin, cout / CLUSTER), so a rank's slice is one dense block and a
// warp's loads fall on one to four 128-byte lines. In the flax layout a rank's 4-16 channels
// of a row are a 16-64 byte piece of a line and a warp's load touches 8 to 16 lines; at 8
// rows per item that layout was slower on the H100.
//
// bf16 weights (the JAX builders' weights_dtype=jnp.bfloat16, ops/fused_unet.py:221-226):
// the conv functions below take their kernel's element type WT, float or __nv_bfloat16. In
// bf16 every conv kernel of the body (and the final 1x1 conv of the CFG kernels) is read as 2
// bytes from a bf16 copy of the packed buffer at the same element offsets, and every product's
// activation operand is rounded to bf16, to nearest even, before its fp32 FMA, as
// `xs.astype(w.dtype)` does in the JAX body (fused_unet.py:108, :279, :313). The product of two
// bf16 numbers is exact in fp32, so this is JAX's bf16 x bf16 -> fp32 product up to the order
// of the fp32 sums. Biases, GroupNorm's scale and bias, FiLM and everything else stay fp32 and
// are read from the fp32 buffer W. In the float instantiation the code is what it was:
// conv_weights<float> is W itself, Wh is never read, and round_operand<float> is the identity.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "unet_body.cuh"

namespace cg = cooperative_groups;

#define CLUSTER 8  // CTAs per cluster, ranks of the split (a portable cluster size)
#define CL_RPT 8  // rows per work item of a conv (a power of two)
#define CL_SPLIT 32  // most lanes one item's reduction is split over (a power of two <= 32)

// The conv kernels a kernel of element type WT reads: W itself in float, the bf16 copy Wh
// (same element offsets) in bf16.
template <typename WT>
static __device__ __forceinline__ const WT* conv_weights(const float* W,
                                                         const __nv_bfloat16* Wh) {
  if constexpr (std::is_same<WT, float>::value) return W;
  else return Wh;
}

static __device__ __forceinline__ float wload(const float* p) { return __ldg(p); }
static __device__ __forceinline__ float wload(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));  // exact
}

// A product's activation operand as a kernel of weight type WT takes it: itself in float,
// rounded to bf16 (to nearest even) in bf16.
template <typename WT>
static __device__ __forceinline__ float round_operand(float x) {
  if constexpr (std::is_same<WT, float>::value) return x;
  else return __bfloat162float(__float2bfloat16_rn(x));
}

// lanes per item: the largest power of two <= CL_SPLIT with items * S <= NT (at least 1)
static __device__ __forceinline__ int split_lanes(int items) {
  int s = 1;
  while (2 * s <= CL_SPLIT && items * 2 * s <= NT) s *= 2;
  return s;
}

// The end of a conv item: acc holds one lane's partial sums of the CL_RPT rows r0.. of
// channel co, and the item's S lanes (a power of two, s = this lane's index among them) sum
// them. While a lane holds more than one row, each step halves them: the lane keeps one half
// and trades the other with its partner, so S lanes sum CL_RPT rows in log2(S) rounds of at
// most CL_RPT / 2 shuffles, and each row ends in S / CL_RPT lanes (or a lane keeps
// CL_RPT / S rows). Then bias + sum goes to `out` of this CTA (one lane per row) or, PUSH, of
// every CTA of the cluster (the lanes that hold a row share its CLUSTER stores). Every lane of
// the warp must call it, active or not.
template <bool PUSH>
static __device__ __forceinline__ void reduce_store(float (&acc)[CL_RPT], int S, int s,
                                                    bool active, int r0, int rows, int hout,
                                                    int cout, int co, float bv, float* out) {
  int o = S >> 1, row = 0, held = CL_RPT;
#pragma unroll
  for (int h = CL_RPT / 2; h >= 1; h >>= 1) {
    if (o > 0) {
      const bool upper = (s & o) != 0;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = upper ? acc[i] : acc[i + h];
        const float keep = upper ? acc[i + h] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      if (upper) row += h;
      held = h;
      o >>= 1;
    }
  }
  const int dup = o > 0 ? 2 * o : 1;  // lanes that end with the same row
  for (; o > 0; o >>= 1) acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
  if (!active) return;
  const int first = s & (dup - 1);
#pragma unroll
  for (int i = 0; i < CL_RPT; ++i) {
    const int r = r0 + row + i;
    if (i < held && r < rows) {
      const int b = r / hout, t = r - b * hout;
      const int at = row_off(b, hout, t, cout) + co;
      const float v = acc[i] + bv;
      if (PUSH) {
        for (int d = first; d < CLUSTER; d += dup) cg::this_cluster().map_shared_rank(out, d)[at] = v;
      } else if (first == 0) {
        out[at] = v;
      }
    }
  }
}

// The rank's channels [c0, c0 + nc) of a conv over NB row-sets:
// out[b][t][co] = bias[co] + sum_k sum_ci in[b][stride*t + k - pad][ci] * w[k][ci][co],
// interior rows only, with w the rank-major (CLUSTER, ks * cin, nc) kernel of element type WT.
// PUSH: into `out` of every CTA of the cluster, else of this CTA only.
template <int NB, bool PUSH, typename WT>
static __device__ void cconv(const float* in, int hin, int cin, float* out, int hout, int cout,
                             const WT* __restrict__ w, const float* __restrict__ bias, int ks,
                             int stride, int pad, int c0, int nc) {
  const int rows = NB * hout;
  const int items = ((rows + CL_RPT - 1) / CL_RPT) * nc;
  const int S = split_lanes(items), log2s = __ffs(S) - 1;
  const int K = ks * cin;  // the k taps of a row are contiguous in the halo layout
  const WT* wr = w + (size_t)c0 * K;  // the rank's (K, nc) block of the rank-major kernel
  for (int base = 0; base < items * S; base += NT) {  // uniform trip count: whole warps shuffle
    const int idx = base + threadIdx.x;
    const bool active = idx < items * S;
    const int s = idx & (S - 1), item = idx >> log2s;
    const int j = item % nc, r0 = (item / nc) * CL_RPT;
    int src[CL_RPT];
    float acc[CL_RPT];
#pragma unroll
    for (int i = 0; i < CL_RPT; ++i) {
      const int r = min(r0 + i, rows - 1);  // a short last chunk repeats its last row
      const int b = r / hout, t = r - b * hout;
      src[i] = row_off(b, hin, stride * t - pad, cin);
      acc[i] = 0.f;
    }
    if (active) {
      const WT* wc = wr + j;
#pragma unroll 4
      for (int q = s; q < K; q += S) {
        const float wv = wload(wc + (size_t)q * nc);
#pragma unroll
        for (int i = 0; i < CL_RPT; ++i)
          acc[i] = fmaf(round_operand<WT>(in[src[i] + q]), wv, acc[i]);
      }
    }
    reduce_store<PUSH>(acc, S, s, active, r0, rows, hout, cout, c0 + j,
                       active ? __ldg(bias + c0 + j) : 0.f, out);
  }
}

// The rank's channels [c0, c0 + nc) of Upsample1d, the flax ConvTranspose(k4, s2, padding
// (2, 2)) without kernel flip, pushed into `out` of every CTA:
// out[2t] = b + w0 x[t-1] + w2 x[t], out[2t+1] = b + w1 x[t] + w3 x[t+1];
// w is the rank-major (CLUSTER, 4 c, nc) kernel of element type WT.
template <int NB, typename WT>
static __device__ void cupsample_push(const float* in, int hin, int c, float* out,
                                      const WT* __restrict__ w,
                                      const float* __restrict__ bias, int c0, int nc) {
  const int hout = 2 * hin, rows = NB * hout;
  const int items = ((rows + CL_RPT - 1) / CL_RPT) * nc;
  const int S = split_lanes(items), log2s = __ffs(S) - 1;
  const WT* wr = w + (size_t)c0 * 4 * c;
  for (int base = 0; base < items * S; base += NT) {
    const int idx = base + threadIdx.x;
    const bool active = idx < items * S;
    const int s = idx & (S - 1), item = idx >> log2s;
    const int j = item % nc, r0 = (item / nc) * CL_RPT;
    int src[CL_RPT];
    bool odd[CL_RPT];
    float acc[CL_RPT];
#pragma unroll
    for (int i = 0; i < CL_RPT; ++i) {
      const int r = min(r0 + i, rows - 1);
      const int b = r / hout, t = r - b * hout;
      odd[i] = t & 1;
      // tap pair kk = 0, 1 reads input rows (t>>1) - 1 + odd + kk: input q = kk * c + ci
      src[i] = row_off(b, hin, (t >> 1) - 1 + (t & 1), c);
      acc[i] = 0.f;
    }
    if (active) {
#pragma unroll 4
      for (int q = s; q < 2 * c; q += S) {
        const int wq = q < c ? q : q + c;  // tap 2kk (even rows) at row wq, 2kk+1 at wq + c
        const float ve = wload(wr + (size_t)wq * nc + j);
        const float vo = wload(wr + (size_t)(wq + c) * nc + j);
#pragma unroll
        for (int i = 0; i < CL_RPT; ++i)
          acc[i] = fmaf(round_operand<WT>(in[src[i] + q]), odd[i] ? vo : ve, acc[i]);
      }
    }
    reduce_store<true>(acc, S, s, active, r0, rows, hout, c, c0 + j,
                       active ? __ldg(bias + c0 + j) : 0.f, out);
  }
}

// GroupNorm statistics of the rank's group (channels [c0, c0 + nc)) of every row-set, one
// warp per row-set: stats[2b] = mean, stats[2b + 1] = 1 / sqrt(var + eps), the variance as
// E[y^2] - mean^2 (unet_body.cuh's gn_mish).
template <int NB>
static __device__ void cgroup_stats(const float* buf, int h, int c, int c0, int nc, float* stats,
                                    float eps) {
  const int b = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (b >= NB) return;
  const int n = h * nc;
  float s = 0.f, sq = 0.f;
  for (int e = lane; e < n; e += 32) {
    const int t = e / nc;
    const float v = buf[row_off(b, h, t, c) + c0 + (e - t * nc)];
    s += v;
    sq = fmaf(v, v, sq);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  if (lane == 0) {
    const float mean = s / (float)n;
    const float var = fmaxf(sq / (float)n - mean * mean, 0.f);
    stats[2 * b] = mean;
    stats[2 * b + 1] = 1.0f / sqrtf(var + eps);
  }
}

// On the rank's channels: y = mish(GroupNorm(buf) * gamma + beta), plus the FiLM bias of the
// row-set (film_c for row-set 0, film_u for 1) or the residual res, stored into buf of every
// CTA of the cluster. Needs cgroup_stats' stats.
template <int NB>
static __device__ void cgn_mish_push(float* buf, int h, int c, int c0, int nc,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta, const float* film_c,
                                     const float* film_u, const float* res, const float* stats,
                                     int rank) {
  const int total = NB * h * nc;
  for (int i = threadIdx.x; i < total; i += NT) {
    const int r = i / nc, ch = c0 + (i - r * nc), b = r / h, t = r - b * h;
    const int o = row_off(b, h, t, c) + ch;
    float y = (buf[o] - stats[2 * b]) * stats[2 * b + 1] * __ldg(gamma + ch) + __ldg(beta + ch);
    y = mish_f(y);
    if (film_c != nullptr) y += (b == 0 ? film_c : film_u)[ch];
    if (res != nullptr) y += res[o];
    for (int d = 0; d < CLUSTER; ++d)  // staggered, so the ranks do not all start at CTA 0
      cg::this_cluster().map_shared_rank(buf, (rank + d) % CLUSTER)[o] = y;
  }
}

// ResidualTemporalBlock on the cluster: in -> t2 (t1 is scratch). Returns t2. The conv kernels
// come from conv_weights<WT>(W, Wh), everything else from W.
template <int NB, typename WT>
static __device__ float* cres_block(const int* rm, const float* __restrict__ W,
                                    const __nv_bfloat16* __restrict__ Wh, const float* in,
                                    float* t1, float* t2, int h, const float* film_c,
                                    const float* film_u, float* stats, int rank) {
  const int cin = rm[R_CIN], cout = rm[R_COUT];
  const int nc = cout / CLUSTER, c0 = rank * nc;
  const WT* Wc = conv_weights<WT>(W, Wh);
  cconv<NB, false>(in, h, cin, t1, h, cout, Wc + rm[R_W1], W + rm[R_B1], 5, 1, 2, c0, nc);
  zero_halo<NB>(t1, h, cout);
  __syncthreads();
  cgroup_stats<NB>(t1, h, cout, c0, nc, stats, 1e-5f);
  __syncthreads();
  cgn_mish_push<NB>(t1, h, cout, c0, nc, W + rm[R_G1], W + rm[R_BE1], film_c, film_u, nullptr,
                    stats, rank);
  cg::this_cluster().sync();
  cconv<NB, false>(t1, h, cout, t2, h, cout, Wc + rm[R_W2], W + rm[R_B2], 5, 1, 2, c0, nc);
  zero_halo<NB>(t2, h, cout);
  __syncthreads();
  cgroup_stats<NB>(t2, h, cout, c0, nc, stats, 1e-5f);
  const float* res = in;
  if (rm[R_WR] >= 0) {  // 1x1 residual conv into the rank's channels of t1, read by no one else
    cconv<NB, false>(in, h, cin, t1, h, cout, Wc + rm[R_WR], W + rm[R_BR], 1, 1, 0, c0, nc);
    res = t1;
  }
  __syncthreads();
  cgn_mish_push<NB>(t2, h, cout, c0, nc, W + rm[R_G2], W + rm[R_BE2], nullptr, nullptr, res,
                    stats, rank);
  cg::this_cluster().sync();
  return t2;
}

// The conv backbone on the (NB, H, D) rows in *cur, which every CTA holds; returns the
// buffer that holds the final Conv1dBlock's output (NB, H, dims[1]) in every CTA. films is
// (n_res, n_rows, max_c) with at least the rank's channels of each block written: row-set 0
// takes FiLM row row0, row-set 1 row row1. Ends at a cluster barrier. The conv kernels come
// from conv_weights<WT>(W, Wh), everything else from W.
template <int NB, typename WT>
static __device__ float* cunet_body(const int* m, const float* __restrict__ W,
                                    const __nv_bfloat16* __restrict__ Wh, float* smem,
                                    float* cur, float* f1, float* f2, const float* films,
                                    int n_rows, int row0, int row1, float* stats, int rank) {
  const int nlev = m[M_NLEV], maxc = m[M_MAXC];
  const WT* Wc = conv_weights<WT>(W, Wh);
  int h = m[M_H];
  int r = 0;
#define FILM(rr, row) (films + ((size_t)(rr) * n_rows + (row)) * maxc)
#define RES_BLOCK()                                                                          \
  {                                                                                          \
    float* out = cres_block<NB, WT>(m + M_RES + r * RES_STRIDE, W, Wh, cur, f1, f2, h,        \
                                FILM(r, row0), FILM(r, row1), stats, rank);                  \
    f2 = f1;                                                                                 \
    f1 = cur;                                                                                \
    cur = out;                                                                               \
    ++r;                                                                                     \
  }
  for (int lvl = 0; lvl < nlev; ++lvl) {
    RES_BLOCK();
    RES_BLOCK();
    const int c = m[M_DIMS + lvl + 1];
    if (lvl > 0) {  // keep the skip; level 0's is never read
      float* skip = smem + m[M_SKIP + lvl];
      const int n = NB * (h + 2 * HALO) * c;
      for (int i = threadIdx.x; i < n; i += NT) skip[i] = cur[i];
    }
    if (lvl < nlev - 1) {  // Downsample1d: conv k3 s2 p1, pushed
      const int nc = c / CLUSTER;
      cconv<NB, true>(cur, h, c, f1, h / 2, c, Wc + m[M_DOWN + 2 * lvl],
                      W + m[M_DOWN + 2 * lvl + 1], 3, 2, 1, rank * nc, nc);
      zero_halo<NB>(f1, h / 2, c);
      h /= 2;
      float* tmp = cur; cur = f1; f1 = tmp;
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  }
  RES_BLOCK();  // mid blocks
  RES_BLOCK();
  for (int u = 0; u < nlev - 1; ++u) {
    const int lvl = nlev - 1 - u;
    const int c = m[M_DIMS + lvl + 1];  // channels of cur and of skip[lvl]
    const float* skip = smem + m[M_SKIP + lvl];
    const int n = NB * h * 2 * c;
    for (int i = threadIdx.x; i < n; i += NT) {  // concat(cur, skip) along channels
      const int ch = i % (2 * c), rr = i / (2 * c), b = rr / h, t = rr - b * h;
      f1[row_off(b, h, t, 2 * c) + ch] =
          ch < c ? cur[row_off(b, h, t, c) + ch] : skip[row_off(b, h, t, c) + ch - c];
    }
    zero_halo<NB>(f1, h, 2 * c);
    __syncthreads();
    // cur was read above since the last cluster barrier, so the next block's t1, which the
    // ranks push into before the next barrier, must be f2, and not cur
    { float* tmp = cur; cur = f1; f1 = f2; f2 = tmp; }
    RES_BLOCK();
    RES_BLOCK();
    const int cd = m[M_DIMS + lvl], nc = cd / CLUSTER;
    cupsample_push<NB>(cur, h, cd, f1, Wc + m[M_UP + 2 * u], W + m[M_UP + 2 * u + 1], rank * nc,
                       nc);
    zero_halo<NB>(f1, 2 * h, cd);
    h *= 2;
    { float* tmp = cur; cur = f1; f1 = tmp; }
    cg::this_cluster().sync();
  }
#undef RES_BLOCK
#undef FILM
  const int cf = m[M_DIMS + 1], nc = cf / CLUSTER, c0 = rank * nc;
  cconv<NB, false>(cur, h, cf, f1, h, cf, Wc + m[M_FIN], W + m[M_FIN + 1], 5, 1, 2, c0, nc);
  __syncthreads();
  cgroup_stats<NB>(f1, h, cf, c0, nc, stats, 1e-5f);
  __syncthreads();
  cgn_mish_push<NB>(f1, h, cf, c0, nc, W + m[M_FIN + 2], W + m[M_FIN + 3], nullptr, nullptr,
                    nullptr, stats, rank);
  cg::this_cluster().sync();
  return f1;
}
