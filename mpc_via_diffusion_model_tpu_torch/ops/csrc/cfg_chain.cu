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
// The U-Net body and the meta-table indices are in unet_body.cuh, shared with
// cfg_episode.cu and fused_unet.cu.

#include "unet_body.cuh"

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
  const int* m = load_meta(smem, meta, __ldg(meta + M_SMEM));
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
    zero_halo<2>(in, H, D);
    __syncthreads();
    const float* y = unet_body<2>(m, W, smem, in, smem + buf, smem + 2 * buf,
                                  films + (size_t)si * n_res * 2 * n_samples * maxc,
                                  2 * n_samples, sample, n_samples + sample, stats);
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
