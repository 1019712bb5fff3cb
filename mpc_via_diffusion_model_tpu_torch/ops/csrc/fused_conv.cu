// Fused Conv1d(k5, 'same') + optional FiLM pre-bias + GroupNorm + Mish as ONE CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_conv.py::fused_conv1d_gn_mish
// (pallas_call at fused_conv.py:154): x (B, H, Cin) plus pre_bias (B, Cin) where given, the
// 'same' convolution with w (5, Cin, Cout) in flax's layout and bias b, GroupNorm over
// (H, Cout / groups) per batch element and group with gamma and beta, then Mish.
//
// What bounds it on this card. At the largest of the six shapes that
// scripts/bench_kernels.py times, (B, H, Cin, Cout) = (64, 8, 64, 128), the block is
// 2 * 64 * 8 * 5 * 64 * 128 = 41.9 MFLOP, 0.63 us at 67 TFLOP/s fp32, and it reads and writes
// about 0.56 MB, 0.17 us at 3.35 TB/s: bound by operations, and both far below one launch. At
// every one of the six shapes the kernel is bound by its launch, and through the ctypes wrapper
// by the host.
//
// What the design does about it: the simple design, one launch for the whole block, as the
// Pallas grid has it. grid = B; block b loads row b into the halo layout of unet_body.cuh (the
// pre-bias added to the interior rows only: the reference pads x + pre_bias with zeros, so the
// halo rows stay 0), runs conv<1> (a thread owns one output channel and RPT rows, weights from
// L2) and gn_mish<1> (one warp per group, variance as E[y^2] - mean^2 as fused_conv.py:117
// computes it, clamped at 0) in shared memory, and writes its (H, Cout) rows. Shared memory:
// (H + 4) * Cin + (H + 4) * Cout + 2 * groups floats, checked by the wrapper against the
// card's 227 KB. Making it fast is later work.

#include "unet_body.cuh"

__global__ void __launch_bounds__(NT, 1)
fused_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const float* __restrict__ pre_bias,
                  float* __restrict__ out, int H, int cin, int cout, int groups, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* in = smem;
  float* y = in + (H + 2 * HALO) * cin;
  float* stats = y + (H + 2 * HALO) * cout;
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < H * cin; i += NT) {
    const int ci = i % cin, t = i / cin;
    float v = x[(size_t)b * H * cin + i];
    if (pre_bias != nullptr) v += pre_bias[(size_t)b * cin + ci];
    in[row_off(0, H, t, cin) + ci] = v;
  }
  zero_halo<1>(in, H, cin);
  __syncthreads();
  conv<1>(in, H, cin, y, H, cout, w, bias, 5, 1, 2);
  __syncthreads();
  gn_mish<1>(y, H, cout, groups, gamma, beta, stats, eps);
  __syncthreads();
  for (int i = threadIdx.x; i < H * cout; i += NT) {
    const int co = i % cout, t = i / cout;
    out[(size_t)b * H * cout + i] = y[row_off(0, H, t, cout) + co];
  }
}

extern "C" {

// Launches the block on `stream` for `batch` elements; pre_bias may be null. Returns the CUDA
// error code (0 = launched).
int fused_conv_launch(const float* x, const float* w, const float* bias, const float* gamma,
                      const float* beta, const float* pre_bias, float* out, int batch, int H,
                      int cin, int cout, int groups, float eps, int smem_bytes, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_conv_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  fused_conv_kernel<<<batch, NT, smem_bytes, (cudaStream_t)stream>>>(
      x, w, bias, gamma, beta, pre_bias, out, H, cin, cout, groups, eps);
  return (int)cudaGetLastError();
}

const char* fused_conv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The meta layout of unet_body.cuh, which this library includes; the binder checks every
// library's against ops/unet_pack.py.
int fused_conv_meta_len(void) { return M_LEN; }

}  // extern "C"
