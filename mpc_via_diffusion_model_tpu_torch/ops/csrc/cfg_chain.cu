// The whole T+tail CFG DDPM chain of one replan as ONE CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_denoise.py::make_fused_cfg_chain
// (pallas_call at fused_denoise.py:151), with the U-Net body it traces in
// (ops/fused_unet.py::build_unet_ops). Per step it runs the conv backbone on the doubled
// batch (conditional rows, then unconditional rows), the final 1x1 conv, the CFG
// combination of the x0 reconstructions, the clip and the posterior update:
//
//   recon_b = sra * x - srm * eps_b                 (b = cond, uncond)
//   recon   = clip((1 + w) * recon_cond - w * recon_uncond, -1, 1)
//   x       = c1 * recon + c2 * x + (sigma * gate) * noise
//
// in that order and without FMA contraction (__fmul_rn / __fadd_rn), as the JAX kernel
// and the plain version do: at the first step sra = srm = 1e6, so any other rounding of
// these lines shows up a millionfold before the clip.
//
// What bounds it on this card. At the flagship shapes (horizon 32, channels 32/64/128,
// B = 1) one U-Net pass over one batch element is 18.2 MFLOP of conv FMAs
// (ops/unet_pack.py counts them), so a replan is 18.2M x 2 (cond, uncond) x 30 steps
// = 1.09 GFLOP. The weights are 3.83 MB of fp32, read once per step: 115 MB of L2
// traffic per replan, or 3.83 MB of device memory once the first step has pulled them
// into the 50 MB L2. Over the whole card the work is bound by operations (1.09 GFLOP at
// 67 TFLOP/s fp32 = 16 us, against 4.2 MB at 3.35 TB/s = 1.3 us). But the chain is
// sequential: step s+1 needs step s, and inside a step each layer needs the last. With
// one block per sample, one SM does the whole replan: 1.09 GFLOP at one SM's 0.5 TFLOP/s
// (67 / 132) is 2.1 ms at best.
//
// What the design does about it. The first design is simple and correct:
// - grid = n_samples; block b holds sample b's conditional and unconditional rows, because
//   the CFG combination needs both. The loop over steps runs inside the block. There is
//   no inter-block synchronisation, no cooperative launch and no spin-wait, and every
//   loop's trip count is fixed by the launch's arguments.
// - Activations live in shared memory as (2, h + 2*HALO, c) with zero halo rows, so the
//   'same' convs need no edge masks: three rotating buffers, the skips of levels >= 1,
//   x, eps and the GroupNorm statistics, about 96 KB at the flagship shapes (dynamic
//   shared memory, so cudaFuncSetAttribute is called before the launch).
// - Weights stay in device memory and are served from L2. A thread owns one output
//   channel and RPT output rows, so each weight it loads feeds RPT FMAs, and the 32 lanes
//   of a warp load 32 neighbouring weights (C_out is the fastest axis) while reading the
//   same activation, a shared-memory broadcast.
// - GroupNorm per (batch element, group) takes one warp per group (variance as
//   E[y^2] - mean^2, eps 1e-5, as fused_unet.py:112-131), then one elementwise pass does
//   the normalisation, Mish and the FiLM bias.
// wgmma, TMA, clusters and bf16 are not used: making this fast is later work.
//
// The meta table (ops/unet_pack.py) holds the architecture, the weight offsets and the
// shared-memory plan; the indices below mirror that file.

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
#define M_LEN (M_RES + MAX_RES * RES_STRIDE)
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

// offset of row t (may be a halo row, -HALO <= t < h + HALO) of batch element b
static __device__ __forceinline__ int row_off(int b, int h, int t, int c) {
  return (b * (h + 2 * HALO) + HALO + t) * c;
}

static __device__ __forceinline__ float mish_f(float x) {
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // stable softplus
  return x * tanhf(sp);
}

// out[b][t][co] = bias[co] + sum_k sum_ci in[b][stride*t + k - pad][ci] * w[k][ci][co]
// for both batch elements; writes the interior rows of out only.
static __device__ void conv(const float* __restrict__ in, int hin, int cin,
                            float* __restrict__ out, int hout, int cout,
                            const float* __restrict__ w, const float* __restrict__ bias,
                            int ks, int stride, int pad) {
  const int rows = 2 * hout;
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
static __device__ void upsample(const float* __restrict__ in, int hin, int c,
                                float* __restrict__ out,
                                const float* __restrict__ w, const float* __restrict__ bias) {
  const int hout = 2 * hin, rows = 2 * hout;
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

static __device__ void zero_halo(float* buf, int h, int c) {
  const int n = 2 * 2 * HALO * c;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int ch = i % c, q = i / c;
    const int b = q / (2 * HALO), s = q % (2 * HALO);
    const int t = s < HALO ? s - HALO : h + s - HALO;
    buf[row_off(b, h, t, c) + ch] = 0.f;
  }
}

// GroupNorm (per batch element and group) -> Mish -> optional FiLM bias, in place.
static __device__ void gn_mish(float* buf, int h, int c, int groups,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               const float* __restrict__ film_c, const float* __restrict__ film_u,
                               float* stats) {
  const int cpg = c / groups, n = h * cpg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < 2 * groups; p += NT / 32) {
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
  const int total = 2 * h * c;
  for (int i = threadIdx.x; i < total; i += NT) {
    const int ch = i % c, r = i / c, b = r / h, t = r - b * h;
    const int q = b * groups + ch / cpg;
    float* p = buf + row_off(b, h, t, c) + ch;
    float y = (*p - stats[2 * q]) * stats[2 * q + 1] * __ldg(gamma + ch) + __ldg(beta + ch);
    y = mish_f(y);
    if (film_c != nullptr) y += __ldg((b == 0 ? film_c : film_u) + ch);
    *p = y;
  }
}

// dst += src over the interior rows of a (2, h, c) activation
static __device__ void add_into(float* dst, const float* src, int h, int c) {
  const int total = 2 * h * c;
  for (int i = threadIdx.x; i < total; i += NT) {
    const int ch = i % c, r = i / c, b = r / h, t = r - b * h;
    const int o = row_off(b, h, t, c) + ch;
    dst[o] += src[o];
  }
}

// ResidualTemporalBlock: in -> t2 (t1 is scratch). Returns t2.
static __device__ float* res_block(const int* rm, const float* __restrict__ W, float* in, float* t1,
                                   float* t2, int h, const float* film_c, const float* film_u,
                                   float* stats) {
  const int cin = rm[R_CIN], cout = rm[R_COUT], groups = rm[R_GROUPS];
  conv(in, h, cin, t1, h, cout, W + rm[R_W1], W + rm[R_B1], 5, 1, 2);
  zero_halo(t1, h, cout);
  __syncthreads();
  gn_mish(t1, h, cout, groups, W + rm[R_G1], W + rm[R_BE1], film_c, film_u, stats);
  __syncthreads();
  conv(t1, h, cout, t2, h, cout, W + rm[R_W2], W + rm[R_B2], 5, 1, 2);
  zero_halo(t2, h, cout);
  __syncthreads();
  gn_mish(t2, h, cout, groups, W + rm[R_G2], W + rm[R_BE2], nullptr, nullptr, stats);
  __syncthreads();
  if (rm[R_WR] >= 0) {  // 1x1 residual conv when the channel count changes
    conv(in, h, cin, t1, h, cout, W + rm[R_WR], W + rm[R_BR], 1, 1, 0);
    __syncthreads();
    add_into(t2, t1, h, cout);
  } else {
    add_into(t2, in, h, cout);
  }
  __syncthreads();
  return t2;
}

// The conv backbone on the (2, H, D) rows in *cur; returns the buffer that holds the
// final Conv1dBlock's output (2, H, dims[1]). films: this step's (n_res, 2B, max_c).
static __device__ float* unet_body(const int* m, const float* __restrict__ W, float* smem,
                                   float* cur, float* f1, float* f2, const float* films,
                                   int n_samples, int sample, float* stats) {
  const int nlev = m[M_NLEV], maxc = m[M_MAXC];
  int h = m[M_H];
  int r = 0;
#define FILM(rr, bb) (films + ((size_t)(rr) * 2 * n_samples + (bb)) * maxc)
#define RES_BLOCK()                                                                      \
  {                                                                                      \
    float* out = res_block(m + M_RES + r * RES_STRIDE, W, cur, f1, f2, h, FILM(r, sample), \
                           FILM(r, n_samples + sample), stats);                          \
    f2 = f1;                                                                             \
    f1 = cur;                                                                            \
    cur = out;                                                                           \
    ++r;                                                                                 \
  }
  for (int lvl = 0; lvl < nlev; ++lvl) {
    RES_BLOCK();
    RES_BLOCK();
    const int c = m[M_DIMS + lvl + 1];
    if (lvl > 0) {  // keep the skip; level 0's is never read
      float* skip = smem + m[M_SKIP + lvl];
      const int n = 2 * (h + 2 * HALO) * c;
      for (int i = threadIdx.x; i < n; i += NT) skip[i] = cur[i];
    }
    if (lvl < nlev - 1) {  // Downsample1d: conv k3 s2 p1
      conv(cur, h, c, f1, h / 2, c, W + m[M_DOWN + 2 * lvl], W + m[M_DOWN + 2 * lvl + 1], 3, 2, 1);
      zero_halo(f1, h / 2, c);
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
    const int n = 2 * h * 2 * c;
    for (int i = threadIdx.x; i < n; i += NT) {  // concat(cur, skip) along channels
      const int ch = i % (2 * c), rr = i / (2 * c), b = rr / h, t = rr - b * h;
      f1[row_off(b, h, t, 2 * c) + ch] =
          ch < c ? cur[row_off(b, h, t, c) + ch] : skip[row_off(b, h, t, c) + ch - c];
    }
    zero_halo(f1, h, 2 * c);
    __syncthreads();
    { float* tmp = cur; cur = f1; f1 = tmp; }
    RES_BLOCK();
    RES_BLOCK();
    const int cd = m[M_DIMS + lvl];
    upsample(cur, h, cd, f1, W + m[M_UP + 2 * u], W + m[M_UP + 2 * u + 1]);
    zero_halo(f1, 2 * h, cd);
    __syncthreads();
    h *= 2;
    { float* tmp = cur; cur = f1; f1 = tmp; }
  }
#undef RES_BLOCK
#undef FILM
  const int cf = m[M_DIMS + 1];
  conv(cur, h, cf, f1, h, cf, W + m[M_FIN], W + m[M_FIN + 1], 5, 1, 2);
  __syncthreads();
  gn_mish(f1, h, cf, m[M_FIN + 4], W + m[M_FIN + 2], W + m[M_FIN + 3], nullptr, nullptr, stats);
  __syncthreads();
  return f1;
}

// films (n_total, n_res, 2B, max_c); noise (n_total + 1, B, H, D) with row n_total = x_T;
// coefs (n_total, 5) = sra, srm, c1, c2, sigma * gate; out (B, H, D).
__global__ void __launch_bounds__(NT, 1)
cfg_chain_kernel(const float* __restrict__ W, const int* __restrict__ meta,
                 const float* __restrict__ films, const float* __restrict__ noise,
                 const float* __restrict__ coefs, float* __restrict__ out, int n_total,
                 float w, float wp1) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int sample = blockIdx.x, n_samples = gridDim.x;
  int* m = reinterpret_cast<int*>(smem + __ldg(meta + M_SMEM));
  for (int i = threadIdx.x; i < M_LEN; i += NT) m[i] = __ldg(meta + i);
  __syncthreads();
  const int H = m[M_H], D = m[M_D], n_res = m[M_NRES], maxc = m[M_MAXC], buf = m[M_BUF];
  const int hd = H * D;
  float* xs = smem + m[M_XS];
  float* eps = smem + m[M_EPS];
  float* stats = smem + m[M_STATS];
  const size_t noise_step = (size_t)n_samples * hd;
  for (int i = threadIdx.x; i < hd; i += NT)
    xs[i] = noise[(size_t)n_total * noise_step + (size_t)sample * hd + i];
  __syncthreads();

  const int cf = m[M_DIMS + 1];
  const float* w1 = W + m[M_F1];
  const float* b1 = W + m[M_F1 + 1];
  for (int si = 0; si < n_total; ++si) {
    float* in = smem;
    for (int i = threadIdx.x; i < 2 * hd; i += NT) {  // x twice: cond rows, uncond rows
      const int d = i % D, rr = i / D, b = rr / H, t = rr - b * H;
      in[row_off(b, H, t, D) + d] = xs[t * D + d];
    }
    zero_halo(in, H, D);
    __syncthreads();
    const float* y = unet_body(m, W, smem, in, smem + buf, smem + 2 * buf,
                               films + (size_t)si * n_res * 2 * n_samples * maxc, n_samples,
                               sample, stats);
    for (int i = threadIdx.x; i < 2 * hd; i += NT) {  // final 1x1 conv
      const int d = i % D, rr = i / D, b = rr / H, t = rr - b * H;
      const float* yr = y + row_off(b, H, t, cf);
      float acc = 0.f;
      for (int ci = 0; ci < cf; ++ci) acc = fmaf(yr[ci], __ldg(w1 + ci * D + d), acc);
      eps[i] = acc + __ldg(b1 + d);
    }
    __syncthreads();
    const float* cs = coefs + (size_t)si * 5;
    const float sra = __ldg(cs), srm = __ldg(cs + 1), c1 = __ldg(cs + 2), c2 = __ldg(cs + 3),
                sg = __ldg(cs + 4);
    const float* nz = noise + (size_t)si * noise_step + (size_t)sample * hd;
    for (int i = threadIdx.x; i < hd; i += NT) {
      const float x = xs[i];
      const float rc = __fsub_rn(__fmul_rn(sra, x), __fmul_rn(srm, eps[i]));
      const float ru = __fsub_rn(__fmul_rn(sra, x), __fmul_rn(srm, eps[hd + i]));
      float rec = __fsub_rn(__fmul_rn(wp1, rc), __fmul_rn(w, ru));
      rec = fminf(fmaxf(rec, -1.f), 1.f);
      const float mean = __fadd_rn(__fmul_rn(c1, rec), __fmul_rn(c2, x));
      xs[i] = __fadd_rn(mean, __fmul_rn(sg, __ldg(nz + i)));
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < hd; i += NT) out[(size_t)sample * hd + i] = xs[i];
}

extern "C" {

// Launches the chain on `stream`; returns the CUDA error code (0 = launched).
int cfg_chain_launch(const float* W, const int* meta, int smem_bytes, const float* films,
                     const float* noise, const float* coefs, float* out, int n_total,
                     int n_samples, float w, float wp1, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(cfg_chain_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cfg_chain_kernel<<<n_samples, NT, smem_bytes, (cudaStream_t)stream>>>(
      W, meta, films, noise, coefs, out, n_total, w, wp1);
  return (int)cudaGetLastError();
}

const char* cfg_chain_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int cfg_chain_meta_len(void) { return M_LEN; }

}  // extern "C"
