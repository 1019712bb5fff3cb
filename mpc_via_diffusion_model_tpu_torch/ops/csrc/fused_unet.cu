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
// (ops/unet_pack.py::cluster_weights). Activations use the one-row-set plan (ops/unet_pack.py,
// metas[1]) in every CTA: 154,764 B per CTA at the panda arm's horizon 128, where the CFG
// kernels' two-row-set plan (304,780 B) is more than a block may take.
//
// fused_unet_max_active_clusters answers cudaOccupancyMaxActiveClusters at the pass's shared
// memory: the wrapper refuses to launch when it is 0.
//
// bf16 weights (the JAX builder's weights_dtype=jnp.bfloat16, fused_unet.py:387-388): the
// kernel is a template on the conv kernels' element type WT. fused_unet_launch runs the float
// instantiation and fused_unet_bf16_launch the __nv_bfloat16 one, which reads the body's conv
// kernels from the bf16 copy Wh of the buffer and rounds each product's activation operand to
// bf16 (unet_body_cluster.cuh). The final 1x1 conv stays outside the kernel in fp32 on an
// unrounded y, as the JAX builder computes it (`y @ f1_w[0] + f1_w[1]`, fused_unet.py:450, with
// f1_w taken raw from build_unet_ops). Each entry has its own occupancy query.

#include "unet_body_cluster.cuh"

// W is the packed buffer with the body's conv kernels rank-major (cluster_weights), Wh its
// bf16 copy (read in the bf16 instantiation only; last, so that the float instantiation's
// other parameters keep their offsets). x (B, H, D); films (n_res, B, max_c);
// out (B, H, dims[1]).
template <typename WT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT, 1)
fused_unet_kernel(const float* __restrict__ W, const int* __restrict__ meta,
                  const float* __restrict__ films, const float* __restrict__ x,
                  float* __restrict__ out, const __nv_bfloat16* __restrict__ Wh) {
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
  const float* y = cunet_body<1, WT>(m, W, Wh, smem, in, smem + buf, smem + 2 * buf, films,
                                     batch, b, b, smem + m[M_STATS], rank);
  if (rank == 0)
    for (int i = threadIdx.x; i < H * cf; i += NT) {
      const int ch = i % cf, t = i / cf;
      out[(size_t)b * H * cf + i] = y[row_off(0, H, t, cf) + ch];
    }
  cg::this_cluster().sync();  // no CTA leaves while another may still write into it
}

// reserve_smem's record of the shared-memory limit set for each instantiation on each device,
// in an anonymous namespace: a template's static member of external linkage is one object in
// the whole process (the loader unifies it across libraries).
namespace {
template <typename WT>
struct SmemSet {
  static int set[MAX_DEVICES];
};
template <typename WT>
int SmemSet<WT>::set[MAX_DEVICES];
}  // namespace

template <typename WT>
static int launch(const float* W, const __nv_bfloat16* Wh, const int* meta, int smem_bytes,
                  const float* films, const float* x, float* out, int batch, void* stream) {
  cudaError_t e = reserve_smem(fused_unet_kernel<WT>, smem_bytes, SmemSet<WT>::set);
  if (e != cudaSuccess) return (int)e;
  fused_unet_kernel<WT><<<CLUSTER * batch, NT, smem_bytes, (cudaStream_t)stream>>>(
      W, meta, films, x, out, Wh);
  return (int)cudaGetLastError();
}

template <typename WT>
static int max_active_clusters(int smem_bytes, int* n_clusters) {
  *n_clusters = 0;
  cudaError_t e = reserve_smem(fused_unet_kernel<WT>, smem_bytes, SmemSet<WT>::set);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER);
  config.blockDim = dim3(NT);
  config.dynamicSmemBytes = smem_bytes;  // the cluster shape is the kernel's __cluster_dims__
  return (int)cudaOccupancyMaxActiveClusters(n_clusters, (void*)fused_unet_kernel<WT>, &config);
}

// Each entry's C interface besides <entry>_launch.
#define FUSED_UNET_QUERIES(ENTRY, WT_)                                                        \
  int ENTRY##_max_active_clusters(int smem_bytes, int* n_clusters) {                          \
    return max_active_clusters<WT_>(smem_bytes, n_clusters);                                  \
  }                                                                                           \
  int ENTRY##_cluster_size(void) { return CLUSTER; }                                          \
  const char* ENTRY##_error_string(int code) {                                                \
    return cudaGetErrorString((cudaError_t)code);                                             \
  }                                                                                           \
  int ENTRY##_meta_len(void) { return M_LEN; }

extern "C" {

// Launches one pass, one cluster per batch row, on `stream`; returns the CUDA error code
// (0 = launched).
int fused_unet_launch(const float* W, const int* meta, int smem_bytes, const float* films,
                      const float* x, float* out, int batch, void* stream) {
  return launch<float>(W, nullptr, meta, smem_bytes, films, x, out, batch, stream);
}

// The same with bf16 conv kernels: Wh is the bf16 copy of W (same element offsets).
int fused_unet_bf16_launch(const float* W, const __nv_bfloat16* Wh, const int* meta,
                           int smem_bytes, const float* films, const float* x, float* out,
                           int batch, void* stream) {
  return launch<__nv_bfloat16>(W, Wh, meta, smem_bytes, films, x, out, batch, stream);
}

// <entry>_max_active_clusters: cudaOccupancyMaxActiveClusters for one row's cluster at
// smem_bytes of dynamic shared memory per CTA, into *n_clusters; returns the CUDA error code
// (0 = answered).
FUSED_UNET_QUERIES(fused_unet, float)
FUSED_UNET_QUERIES(fused_unet_bf16, __nv_bfloat16)

}  // extern "C"
