// One conv-backbone pass of the temporal U-Net as ONE CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_unet.py::make_fused_unet
// (pallas_call at fused_unet.py:442): the ResidualTemporalBlocks, the down and up sampling,
// the skips and the final Conv1dBlock on a batch of (H, D) rows, with the FiLM biases of
// each row given. The time MLP, the context masking, FiLM and the final 1x1 conv stay in
// torch, as they stay in XLA there (ops/fused_unet.py::FusedUnet).
//
// What bounds it on this card. At the flagship shapes (horizon 32, channels 32/64/128) one
// pass over one row-set is 18.2 MFLOP of conv FMAs; the CFG path runs it on batch 2. Over
// the whole card that is 36 MFLOP at 67 TFLOP/s fp32 = 0.5 us against 3.8 MB of weights at
// 3.35 TB/s = 1.1 us: bound by bytes, and both far below one launch. With one block per
// batch element, one SM does one row-set: 18.2 MFLOP at one SM's ~0.5 TFLOP/s is ~36 us at
// best, and the weights come from L2 once the first pass has pulled them in.
//
// What the design does about it: the simple design first. grid = batch; block b loads row
// b into the halo layout, runs unet_body<1> (unet_body.cuh, the body the chain and episode
// kernels run with two row-sets) with row b's FiLM, and writes y (H, dims[1]). No
// inter-block synchronisation; every loop's trip count is fixed by the launch's arguments.
// Making one pass use more than one SM is later work.

#include "unet_body.cuh"

// x (B, H, D); films (n_res, B, max_c); out (B, H, dims[1]).
__global__ void __launch_bounds__(NT, 1)
fused_unet_kernel(const float* __restrict__ W, const int* __restrict__ meta,
                  const float* __restrict__ films, const float* __restrict__ x,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x, batch = gridDim.x;
  const int* m = load_meta(smem, meta, __ldg(meta + M_SMEM));
  const int H = m[M_H], D = m[M_D], buf = m[M_BUF], cf = m[M_DIMS + 1];
  float* in = smem;
  for (int i = threadIdx.x; i < H * D; i += NT) {
    const int d = i % D, t = i / D;
    in[row_off(0, H, t, D) + d] = x[(size_t)b * H * D + i];
  }
  zero_halo<1>(in, H, D);
  __syncthreads();
  const float* y = unet_body<1>(m, W, smem, in, smem + buf, smem + 2 * buf, films, batch, b, b,
                                smem + m[M_STATS]);
  for (int i = threadIdx.x; i < H * cf; i += NT) {
    const int ch = i % cf, t = i / cf;
    out[(size_t)b * H * cf + i] = y[row_off(0, H, t, cf) + ch];
  }
}

extern "C" {

// Launches one pass on `stream`; returns the CUDA error code (0 = launched).
int fused_unet_launch(const float* W, const int* meta, int smem_bytes, const float* films,
                      const float* x, float* out, int batch, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_unet_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  fused_unet_kernel<<<batch, NT, smem_bytes, (cudaStream_t)stream>>>(W, meta, films, x, out);
  return (int)cudaGetLastError();
}

const char* fused_unet_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int fused_unet_meta_len(void) { return M_LEN; }

}  // extern "C"
