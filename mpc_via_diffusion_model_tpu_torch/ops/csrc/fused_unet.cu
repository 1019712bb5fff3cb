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
// 3.35 TB/s = 1.1 us: bound by bytes, and both far below one launch. But inside a pass every
// layer needs the one before: a chain of small dependent layers, which one SM runs at best
// at its ~0.5 TFLOP/s (~36 us per row; the one-block kernel of the first slices took about
// 0.42 ms, bound by its shared-memory loads and per-layer latency).
//
// What the design does about it: the cluster body of the chains and episodes at one
// row-set. Each batch row is one thread-block cluster of CLUSTER = 8 CTAs on 8 SMs
// (__cluster_dims__, grid = 8 x batch, b = blockIdx.x / CLUSTER), and the U-Net body is
// split over them by output channel, one GroupNorm group per rank (unet_body_cluster.cuh,
// cunet_body<1>): each rank computes an eighth of every conv and pushes its final slices
// into every CTA's shared memory. Every CTA loads row b into the halo layout; rank 0 writes
// y (H, dims[1]). Cluster barriers are the only synchronisation between CTAs (no grid-wide
// sync, no cooperative launch, no spin-wait), and the clusters of different rows share
// nothing, so a batch larger than the clusters that fit at once (15 on the H100) runs in
// waves, correctly. One cluster per row beats one block per row only at small batches: up to
// about 15 rows all clusters run in one wave; beyond that each further 15 rows add a wave
// (~0.18 ms each, PERF.md), and by about 30 rows the one-block kernel of the first slices,
// one wave of up to 132 rows at ~0.42 ms, is as fast. The main path's batch is 2, the CFG
// pair of BENCH_FUSED=1: two clusters on 16 SMs. Weights
// stay in device memory, served from L2, with the body's conv kernels rank-major
// (ops/unet_pack.py::cluster_weights). Activations use the one-block plan (ops/unet_pack.py)
// in every CTA.
//
// fused_unet_max_active_clusters answers cudaOccupancyMaxActiveClusters at the pass's shared
// memory: the wrapper refuses to launch when it is 0.

#include "unet_body_cluster.cuh"

// W is the packed buffer with the body's conv kernels rank-major (cluster_weights).
// x (B, H, D); films (n_res, B, max_c); out (B, H, dims[1]).
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT, 1)
fused_unet_kernel(const float* __restrict__ W, const int* __restrict__ meta,
                  const float* __restrict__ films, const float* __restrict__ x,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / CLUSTER, batch = gridDim.x / CLUSTER;
  const int* m = load_meta(smem, meta, __ldg(meta + M_SMEM));
  const int H = m[M_H], D = m[M_D], buf = m[M_BUF], cf = m[M_DIMS + 1];
  cg::this_cluster().sync();  // every CTA has started before any writes into its shared memory

  float* in = smem;
  for (int i = threadIdx.x; i < H * D; i += NT) {
    const int d = i % D, t = i / D;
    in[row_off(0, H, t, D) + d] = __ldg(x + (size_t)b * H * D + i);
  }
  zero_halo<1>(in, H, D);
  __syncthreads();
  const float* y = cunet_body<1, float>(m, W, nullptr, smem, in, smem + buf, smem + 2 * buf,
                                        films, batch, b, b, smem + m[M_STATS], rank);
  if (rank == 0)
    for (int i = threadIdx.x; i < H * cf; i += NT) {
      const int ch = i % cf, t = i / cf;
      out[(size_t)b * H * cf + i] = y[row_off(0, H, t, cf) + ch];
    }
  cg::this_cluster().sync();  // no CTA leaves while another may still write into it
}

// reserve_smem's record of the shared-memory limit set for the kernel on each device
static int smem_set[MAX_DEVICES];

extern "C" {

// Launches one pass, one cluster per batch row, on `stream`; returns the CUDA error code
// (0 = launched).
int fused_unet_launch(const float* W, const int* meta, int smem_bytes, const float* films,
                      const float* x, float* out, int batch, void* stream) {
  cudaError_t e = reserve_smem(fused_unet_kernel, smem_bytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  fused_unet_kernel<<<CLUSTER * batch, NT, smem_bytes, (cudaStream_t)stream>>>(W, meta, films,
                                                                              x, out);
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters for one row's cluster at smem_bytes of dynamic shared
// memory per CTA, into *n_clusters; returns the CUDA error code (0 = answered).
int fused_unet_max_active_clusters(int smem_bytes, int* n_clusters) {
  *n_clusters = 0;
  cudaError_t e = reserve_smem(fused_unet_kernel, smem_bytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER);
  config.blockDim = dim3(NT);
  config.dynamicSmemBytes = smem_bytes;  // the cluster shape is the kernel's __cluster_dims__
  return (int)cudaOccupancyMaxActiveClusters(n_clusters, (void*)fused_unet_kernel, &config);
}

int fused_unet_cluster_size(void) { return CLUSTER; }

const char* fused_unet_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int fused_unet_meta_len(void) { return M_LEN; }

}  // extern "C"
