// A distilled student's whole DDIM chain of one replan as ONE CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_denoise.py::
// make_fused_ddim_chain (pallas_call at fused_denoise.py:242), with the U-Net body it traces
// in (ops/fused_unet.py::build_unet_ops). The student's guidance is baked in, so there is
// no doubled batch and no injected noise: per step of the static times grid it runs the
// conv backbone on the sample's one row-set, the final 1x1 conv and the affine update
//
//   recon = clip(sra * x - srm * eps, -1, 1)
//   x     = c1 * recon + c2 * x
//
// in that order and without FMA contraction (__fmul_rn / __fadd_rn), as the JAX kernel
// (fused_denoise.py:219-222) and the plain version (diffusion/distillation.py) do.
//
// What bounds it on this card. At the flagship shapes (horizon 32, channels 32/64/128) one
// pass over one row-set is 18.2 MFLOP of conv FMAs (ops/unet_pack.py counts them), so a
// replan on the 1-step grid [23] is 18.2 MFLOP against 3.83 MB of fp32 weights. Over the
// whole card that is bound by bytes (3.8 MB at 3.35 TB/s = 1.1 us against 0.3 us of
// operations at 67 TFLOP/s). With one block per sample, one SM does the replan: 18.2 MFLOP
// at one SM's ~0.5 TFLOP/s is ~36 us at best, the weights coming from L2 once a first
// replan has pulled them in.
//
// What the design does about it: the simple design first, as cfg_chain.cu. grid =
// n_samples; block b runs unet_body<1> (unet_body.cuh, the body every kernel of the port
// shares) on sample b's rows with FiLM row b of each step, and the step loop runs inside
// the block. No inter-block synchronisation; every trip count is fixed by the launch's
// arguments. Activations use the packed shared-memory plan (sized for two row-sets, of
// which this kernel fills one). The step's coefficients and the 1x1 conv's pointers are
// read after the body, where they are used, so that nothing extra stays live in registers
// across the body's conv loops (kept live, they cost the CFG episode kernel 8% on the H100;
// see cfg_episode.cu).

#include "unet_body.cuh"

// films (n_total, n_res, B, max_c); x_init (B, H, D); coefs (n_total, 4) = sra, srm, c1, c2;
// out (B, H, D).
__global__ void __launch_bounds__(NT, 1)
ddim_chain_kernel(const float* __restrict__ W, const int* __restrict__ meta,
                  const float* __restrict__ films, const float* __restrict__ x_init,
                  const float* __restrict__ coefs, float* __restrict__ out, int n_total) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int sample = blockIdx.x, n_samples = gridDim.x;
  const int* m = load_meta(smem, meta, __ldg(meta + M_SMEM));
  const int H = m[M_H], D = m[M_D], n_res = m[M_NRES], maxc = m[M_MAXC], buf = m[M_BUF];
  const int hd = H * D, cf = m[M_DIMS + 1];
  float* xs = smem + m[M_XS];
  float* eps = smem + m[M_EPS];
  float* stats = smem + m[M_STATS];
  for (int i = threadIdx.x; i < hd; i += NT) xs[i] = x_init[(size_t)sample * hd + i];
  __syncthreads();

  for (int si = 0; si < n_total; ++si) {
    float* in = smem;
    for (int i = threadIdx.x; i < hd; i += NT) {
      const int d = i % D, t = i / D;
      in[row_off(0, H, t, D) + d] = xs[i];
    }
    zero_halo<1>(in, H, D);
    __syncthreads();
    const float* y = unet_body<1>(m, W, smem, in, smem + buf, smem + 2 * buf,
                                  films + (size_t)si * n_res * n_samples * maxc, n_samples,
                                  sample, sample, stats);
    const float* w1 = W + m[M_F1];
    const float* b1 = W + m[M_F1 + 1];
    for (int i = threadIdx.x; i < hd; i += NT) {  // final 1x1 conv
      const int d = i % D, t = i / D;
      const float* yr = y + row_off(0, H, t, cf);
      float acc = 0.f;
      for (int ci = 0; ci < cf; ++ci) acc = fmaf(yr[ci], __ldg(w1 + ci * D + d), acc);
      eps[i] = acc + __ldg(b1 + d);
    }
    __syncthreads();
    const float* cs = coefs + (size_t)si * 4;
    const float sra = __ldg(cs), srm = __ldg(cs + 1), c1 = __ldg(cs + 2), c2 = __ldg(cs + 3);
    for (int i = threadIdx.x; i < hd; i += NT) {
      const float x = xs[i];
      float rec = __fsub_rn(__fmul_rn(sra, x), __fmul_rn(srm, eps[i]));
      rec = fminf(fmaxf(rec, -1.f), 1.f);
      xs[i] = __fadd_rn(__fmul_rn(c1, rec), __fmul_rn(c2, x));
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < hd; i += NT) out[(size_t)sample * hd + i] = xs[i];
}

extern "C" {

// Launches the chain on `stream`; returns the CUDA error code (0 = launched).
int ddim_chain_launch(const float* W, const int* meta, int smem_bytes, const float* films,
                      const float* x_init, const float* coefs, float* out, int n_total,
                      int n_samples, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(ddim_chain_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  ddim_chain_kernel<<<n_samples, NT, smem_bytes, (cudaStream_t)stream>>>(
      W, meta, films, x_init, coefs, out, n_total);
  return (int)cudaGetLastError();
}

const char* ddim_chain_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ddim_chain_meta_len(void) { return M_LEN; }

}  // extern "C"
