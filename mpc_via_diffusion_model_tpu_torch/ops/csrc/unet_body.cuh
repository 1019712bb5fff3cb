// The conv backbone of the temporal U-Net as block-wide device functions, shared by every
// kernel of the port: cfg_chain.cu, cfg_episode.cu, fused_unet.cu, ddim_chain.cu and
// ddim_episode.cu.
//
// Port of the U-Net body that mpc_via_diffusion_model_tpu/ops/fused_unet.py::build_unet_ops
// traces into every Pallas kernel of the JAX package. One block runs the body on NB row-sets
// of one horizon each: NB = 2 in the chain and episode kernels (the conditional and the
// unconditional copy of one sample, which the CFG combination needs together), NB = 1 in
// the standalone U-Net kernel (one batch element per block) and in the DDIM chain and
// episode kernels (a distilled student's sample is conditional only).
//
// Activations live in shared memory as (NB, h + 2*HALO, c) with HALO zero rows above and
// below each row-set, so the 'same' convs need no edge masks. Weights stay in device memory
// and are served from L2: a thread owns one output channel and RPT output rows, so each
// weight it loads feeds RPT FMAs, and the 32 lanes of a warp load 32 neighbouring weights
// (C_out is the fastest axis of the flax layout (k, C_in, C_out)) while they read the same
// activation, a shared-memory broadcast. GroupNorm per (row-set, group) takes one warp per
// group (variance as E[y^2] - mean^2, eps 1e-5, as fused_unet.py:112-131), then one
// elementwise pass does the normalisation, Mish and the FiLM bias.
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

// Upsample1d, the flax ConvTranspose(k4, s2, padding (2, 2)) without kernel flip:
// out[2t] = b + w0 x[t-1] + w2 x[t],  out[2t+1] = b + w1 x[t] + w3 x[t+1].
template <int NB>
static __device__ void upsample(const float* __restrict__ in, int hin, int c,
                                float* __restrict__ out,
                                const float* __restrict__ w, const float* __restrict__ bias) {
  const int hout = 2 * hin, rows = NB * hout;
  const int items = ((rows + RPT - 1) / RPT) * c;
  for (int it = threadIdx.x; it < items; it += NT) {
    const int co = it % c;
    const int r0 = (it / c) * RPT;
    int src[RPT];
    bool odd[RPT];
    float acc[RPT];
    const float bv = __ldg(bias + co);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = min(r0 + j, rows - 1);
      const int b = r / hout, t = r - b * hout;
      odd[j] = t & 1;
      // tap pair kk = 0, 1 reads input rows (t>>1) - 1 + odd + kk
      src[j] = row_off(b, hin, (t >> 1) - 1 + (t & 1), c);
      acc[j] = bv;
    }
    for (int kk = 0; kk < 2; ++kk) {
      const float* we = w + (size_t)(2 * kk) * c * c + co;      // tap 2kk for even rows
      const float* wo = w + (size_t)(2 * kk + 1) * c * c + co;  // tap 2kk+1 for odd rows
      const int ko = kk * c;
      for (int ci = 0; ci < c; ++ci) {
        const float ve = __ldg(we + (size_t)ci * c);
        const float vo = __ldg(wo + (size_t)ci * c);
#pragma unroll
        for (int j = 0; j < RPT; ++j) acc[j] = fmaf(in[src[j] + ko + ci], odd[j] ? vo : ve, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = r0 + j;
      if (r < rows) {
        const int b = r / hout, t = r - b * hout;
        out[row_off(b, hout, t, c) + co] = acc[j];
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

// GroupNorm (per row-set and group) -> Mish -> optional FiLM bias, in place. Row-set 0
// takes film_c, row-set 1 film_u.
template <int NB>
static __device__ void gn_mish(float* buf, int h, int c, int groups,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               const float* film_c, const float* film_u, float* stats) {
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
      stats[2 * p + 1] = 1.0f / sqrtf(var + 1e-5f);
    }
  }
  __syncthreads();
  const int total = NB * h * c;
  for (int i = threadIdx.x; i < total; i += NT) {
    const int ch = i % c, r = i / c, b = r / h, t = r - b * h;
    const int q = b * groups + ch / cpg;
    float* p = buf + row_off(b, h, t, c) + ch;
    float y = (*p - stats[2 * q]) * stats[2 * q + 1] * __ldg(gamma + ch) + __ldg(beta + ch);
    y = mish_f(y);
    if (film_c != nullptr) y += (b == 0 ? film_c : film_u)[ch];
    *p = y;
  }
}

// dst += src over the interior rows of a (NB, h, c) activation
template <int NB>
static __device__ void add_into(float* dst, const float* src, int h, int c) {
  const int total = NB * h * c;
  for (int i = threadIdx.x; i < total; i += NT) {
    const int ch = i % c, r = i / c, b = r / h, t = r - b * h;
    const int o = row_off(b, h, t, c) + ch;
    dst[o] += src[o];
  }
}

// ResidualTemporalBlock: in -> t2 (t1 is scratch). Returns t2.
template <int NB>
static __device__ float* res_block(const int* rm, const float* __restrict__ W, float* in,
                                   float* t1, float* t2, int h, const float* film_c,
                                   const float* film_u, float* stats) {
  const int cin = rm[R_CIN], cout = rm[R_COUT], groups = rm[R_GROUPS];
  conv<NB>(in, h, cin, t1, h, cout, W + rm[R_W1], W + rm[R_B1], 5, 1, 2);
  zero_halo<NB>(t1, h, cout);
  __syncthreads();
  gn_mish<NB>(t1, h, cout, groups, W + rm[R_G1], W + rm[R_BE1], film_c, film_u, stats);
  __syncthreads();
  conv<NB>(t1, h, cout, t2, h, cout, W + rm[R_W2], W + rm[R_B2], 5, 1, 2);
  zero_halo<NB>(t2, h, cout);
  __syncthreads();
  gn_mish<NB>(t2, h, cout, groups, W + rm[R_G2], W + rm[R_BE2], nullptr, nullptr, stats);
  __syncthreads();
  if (rm[R_WR] >= 0) {  // 1x1 residual conv when the channel count changes
    conv<NB>(in, h, cin, t1, h, cout, W + rm[R_WR], W + rm[R_BR], 1, 1, 0);
    __syncthreads();
    add_into<NB>(t2, t1, h, cout);
  } else {
    add_into<NB>(t2, in, h, cout);
  }
  __syncthreads();
  return t2;
}

// The conv backbone on the (NB, H, D) rows in *cur; returns the buffer that holds the
// final Conv1dBlock's output (NB, H, dims[1]). films is (n_res, n_rows, max_c): row-set 0
// takes FiLM row row0, row-set 1 row row1.
template <int NB>
static __device__ float* unet_body(const int* m, const float* __restrict__ W, float* smem,
                                   float* cur, float* f1, float* f2, const float* films,
                                   int n_rows, int row0, int row1, float* stats) {
  const int nlev = m[M_NLEV], maxc = m[M_MAXC];
  int h = m[M_H];
  int r = 0;
#define FILM(rr, row) (films + ((size_t)(rr) * n_rows + (row)) * maxc)
#define RES_BLOCK()                                                                        \
  {                                                                                        \
    float* out = res_block<NB>(m + M_RES + r * RES_STRIDE, W, cur, f1, f2, h, FILM(r, row0), \
                               FILM(r, row1), stats);                                      \
    f2 = f1;                                                                               \
    f1 = cur;                                                                              \
    cur = out;                                                                             \
    ++r;                                                                                   \
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
    if (lvl < nlev - 1) {  // Downsample1d: conv k3 s2 p1
      conv<NB>(cur, h, c, f1, h / 2, c, W + m[M_DOWN + 2 * lvl], W + m[M_DOWN + 2 * lvl + 1],
               3, 2, 1);
      zero_halo<NB>(f1, h / 2, c);
      h /= 2;
      float* tmp = cur; cur = f1; f1 = tmp;
    }
    __syncthreads();
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
    { float* tmp = cur; cur = f1; f1 = tmp; }
    RES_BLOCK();
    RES_BLOCK();
    const int cd = m[M_DIMS + lvl];
    upsample<NB>(cur, h, cd, f1, W + m[M_UP + 2 * u], W + m[M_UP + 2 * u + 1]);
    zero_halo<NB>(f1, 2 * h, cd);
    __syncthreads();
    h *= 2;
    { float* tmp = cur; cur = f1; f1 = tmp; }
  }
#undef RES_BLOCK
#undef FILM
  const int cf = m[M_DIMS + 1];
  conv<NB>(cur, h, cf, f1, h, cf, W + m[M_FIN], W + m[M_FIN + 1], 5, 1, 2);
  __syncthreads();
  gn_mish<NB>(f1, h, cf, m[M_FIN + 4], W + m[M_FIN + 2], W + m[M_FIN + 3], nullptr, nullptr,
              stats);
  __syncthreads();
  return f1;
}

// Copies the meta table into shared memory at word offset `at` and returns it.
static __device__ int* load_meta(float* smem, const int* __restrict__ meta, int at) {
  int* m = reinterpret_cast<int*>(smem + at);
  for (int i = threadIdx.x; i < M_LEN; i += NT) m[i] = __ldg(meta + i);
  __syncthreads();
  return m;
}
