// The temporal U-Net body's shared-memory layout, meta table and block-wide helpers: the
// halo layout (row_off, zero_halo), the meta table's indices (load_meta), Mish, and one conv
// (conv<1>) and one GroupNorm + Mish (gn_mish<1>) in one block, which fused_conv.cu runs. The
// U-Net body itself is unet_body_cluster.cuh's, split over a thread-block cluster of 8 CTAs
// in every kernel that runs it: cfg_chain.cu, cfg_episode.cu (two row-sets), fused_unet.cu,
// ddim_chain.cu and ddim_episode.cu (one). It keeps this file's layout, plan and meta table.
//
// Port of the pieces of the U-Net body that mpc_via_diffusion_model_tpu/ops/fused_unet.py::
// build_unet_ops traces into every Pallas kernel of the JAX package.
//
// Activations live in shared memory as (NB, h + 2*HALO, c) with HALO zero rows above and
// below each row-set, so the 'same' convs need no edge masks. In conv<1>, weights stay in
// device memory and are served from L2: a thread owns one output channel and RPT output
// rows, so each weight it loads feeds RPT FMAs, and the 32 lanes of a warp load 32
// neighbouring weights (C_out is the fastest axis of the flax layout (k, C_in, C_out)) while
// they read the same activation, a shared-memory broadcast. gn_mish<1> takes one warp per
// group (variance as E[y^2] - mean^2, as fused_unet.py:112-131), then one elementwise pass
// does the normalisation and Mish.
//
// The meta table (ops/unet_pack.py) holds the architecture, the weight offsets and the
// shared-memory plans; the indices below mirror that file, and every library that includes
// this header reports M_LEN so that the wrapper can check the two agree.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 512          // threads per block
#define RPT 4           // output rows per thread in the conv loops
#define HALO 2          // zero rows above and below each activation
#define MAX_LEVELS 4
#define MAX_RES (4 * MAX_LEVELS)
#define RES_STRIDE 13

// meta layout (ops/unet_pack.py)
#define M_H 0
#define M_D 1
#define M_NLEV 2
#define M_NRES 3
#define M_MAXC 4
#define M_BUF 5
#define M_XS 6
#define M_EPS 7
#define M_STATS 8
#define M_SMEM 9
#define M_DIMS 10
#define M_SKIP (M_DIMS + MAX_LEVELS + 1)
#define M_DOWN (M_SKIP + MAX_LEVELS)
#define M_UP (M_DOWN + 2 * MAX_LEVELS)
#define M_FIN (M_UP + 2 * MAX_LEVELS)
#define M_F1 (M_FIN + 5)
#define M_RES (M_F1 + 2)
// conditioning widths, FiLM Dense weights and the episode kernel's shared-memory plan
#define M_COND (M_RES + MAX_RES * RES_STRIDE)  // cond_dim = time_emb_dim + context_dim (+ 1)
#define M_TEMB (M_COND + 1)                    // time_emb_dim
#define M_CTX (M_COND + 2)                     // context_dim
#define M_FW (M_COND + 3)                      // FiLM kernels (n_res, cond_dim, max_c)
#define M_FB (M_COND + 4)                      // FiLM biases (n_res, max_c)
#define M_EP_FILM (M_COND + 5)                 // shared: this step's FiLM (n_res, 2 or 1, max_c)
#define M_EP_MC (M_COND + 6)                   // shared: mish(c_emb) of the groups (2 or 1, cond_dim)
#define M_EP_MISC (M_COND + 7)                 // shared: state, context, first control, choice
#define M_EP_SMEM (M_COND + 8)                 // shared: the episode kernel's meta copy
#define M_LEN (M_COND + 9)
#define R_CIN 0
#define R_COUT 1
#define R_GROUPS 2
#define R_W1 3
#define R_B1 4
#define R_G1 5
#define R_BE1 6
#define R_W2 7
#define R_B2 8
#define R_G2 9
#define R_BE2 10
#define R_WR 11
#define R_BR 12

// offset of row t (may be a halo row, -HALO <= t < h + HALO) of row-set b
static __device__ __forceinline__ int row_off(int b, int h, int t, int c) {
  return (b * (h + 2 * HALO) + HALO + t) * c;
}

static __device__ __forceinline__ float mish_f(float x) {
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // stable softplus
  return x * tanhf(sp);
}

// out[b][t][co] = bias[co] + sum_k sum_ci in[b][stride*t + k - pad][ci] * w[k][ci][co]
// for every row-set; writes the interior rows of out only.
template <int NB>
static __device__ void conv(const float* __restrict__ in, int hin, int cin,
                            float* __restrict__ out, int hout, int cout,
                            const float* __restrict__ w, const float* __restrict__ bias,
                            int ks, int stride, int pad) {
  const int rows = NB * hout;
  const int items = ((rows + RPT - 1) / RPT) * cout;
  for (int it = threadIdx.x; it < items; it += NT) {
    const int co = it % cout;
    const int r0 = (it / cout) * RPT;
    int src[RPT];
    float acc[RPT];
    const float bv = __ldg(bias + co);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = min(r0 + j, rows - 1);  // a short last chunk repeats its last row
      const int b = r / hout, t = r - b * hout;
      src[j] = row_off(b, hin, stride * t - pad, cin);
      acc[j] = bv;
    }
    for (int k = 0; k < ks; ++k) {
      const float* wk = w + (size_t)k * cin * cout + co;
      const int ko = k * cin;
      for (int ci = 0; ci < cin; ++ci) {
        const float wv = __ldg(wk + (size_t)ci * cout);
#pragma unroll
        for (int j = 0; j < RPT; ++j) acc[j] = fmaf(in[src[j] + ko + ci], wv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = r0 + j;
      if (r < rows) {
        const int b = r / hout, t = r - b * hout;
        out[row_off(b, hout, t, cout) + co] = acc[j];
      }
    }
  }
}

template <int NB>
static __device__ void zero_halo(float* buf, int h, int c) {
  const int n = NB * 2 * HALO * c;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int ch = i % c, q = i / c;
    const int b = q / (2 * HALO), s = q % (2 * HALO);
    const int t = s < HALO ? s - HALO : h + s - HALO;
    buf[row_off(b, h, t, c) + ch] = 0.f;
  }
}

// GroupNorm (per row-set and group, variance eps) -> Mish, in place. stats holds
// 2 * NB * groups floats.
template <int NB>
static __device__ void gn_mish(float* buf, int h, int c, int groups,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               float* stats, float eps) {
  const int cpg = c / groups, n = h * cpg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < NB * groups; p += NT / 32) {
    const int b = p / groups, g = p - b * groups;
    float s = 0.f, sq = 0.f;
    for (int e = lane; e < n; e += 32) {
      const int t = e / cpg, ch = g * cpg + (e - t * cpg);
      const float v = buf[row_off(b, h, t, c) + ch];
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
      stats[2 * p] = mean;
      stats[2 * p + 1] = 1.0f / sqrtf(var + eps);
    }
  }
  __syncthreads();
  const int total = NB * h * c;
  for (int i = threadIdx.x; i < total; i += NT) {
    const int ch = i % c, r = i / c, b = r / h, t = r - b * h;
    const int q = b * groups + ch / cpg;
    float* p = buf + row_off(b, h, t, c) + ch;
    float y = (*p - stats[2 * q]) * stats[2 * q + 1] * __ldg(gamma + ch) + __ldg(beta + ch);
    *p = mish_f(y);
  }
}

// Copies the meta table into shared memory at word offset `at` and returns it.
static __device__ int* load_meta(float* smem, const int* __restrict__ meta, int at) {
  int* m = reinterpret_cast<int*>(smem + at);
  for (int i = threadIdx.x; i < M_LEN; i += NT) m[i] = __ldg(meta + i);
  __syncthreads();
  return m;
}
