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
// operations at 67 TFLOP/s). But every step of the grid needs the one before, and inside a
// pass every layer the one before: a chain of small dependent layers, which one SM runs at
// best at its ~0.5 TFLOP/s (~36 us per pass; the one-block kernel of the first slices took
// 0.42 ms, bound by its shared-memory loads and per-layer latency).
//
// What the design does about it: ddim_episode.cu's body at one row-set, as cfg_chain.cu
// runs it at two. Each sample is one thread-block cluster of CLUSTER = 8 CTAs on 8 SMs
// (__cluster_dims__, grid = 8 x n_samples, sample = blockIdx.x / CLUSTER), and the U-Net
// body is split over them by output channel, one GroupNorm group per rank
// (unet_body_cluster.cuh, cunet_body<1>): each rank computes an eighth of every conv and
// pushes its final slices into every CTA's shared memory. Everything outside the body runs
// redundantly in every CTA, on the same replicated data in the same order: the pass's
// input, the final 1x1 conv and the DDIM lines. Only rank 0 writes the output. The step
// loop runs inside the cluster, its trip count fixed by the launch's arguments, and cluster
// barriers are the only synchronisation between CTAs (no grid-wide sync, no cooperative
// launch, no spin-wait). The K candidates of a replan are the chain's samples, so their
// clusters run side by side. The FiLM table (n_total, n_res, B, max_c) comes from torch and
// is read from device memory, row `sample`. Weights stay in device memory, served from L2,
// with the body's conv kernels rank-major (ops/unet_pack.py::cluster_weights). Activations
// use the one-block plan (ops/unet_pack.py, sized for two row-sets, half used) in every CTA.
// As in the episodes, the step's coefficients and the 1x1 conv's pointers are read after
// the body, where they are used, so that nothing extra stays live across its conv loops.
//
// ddim_chain_max_active_clusters answers cudaOccupancyMaxActiveClusters at the chain's
// shared memory: the wrapper refuses to launch when it is 0.

#include "unet_body_cluster.cuh"

// W is the packed buffer with the body's conv kernels rank-major (cluster_weights).
// films (n_total, n_res, B, max_c); x_init (B, H, D); coefs (n_total, 4) = sra, srm, c1, c2;
// out (B, H, D).
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT, 1)
ddim_chain_kernel(const float* __restrict__ W, const int* __restrict__ meta,
                  const float* __restrict__ films, const float* __restrict__ x_init,
                  const float* __restrict__ coefs, float* __restrict__ out, int n_total) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rank = (int)cg::this_cluster().block_rank();
  const int sample = blockIdx.x / CLUSTER, n_samples = gridDim.x / CLUSTER;
  const int* m = load_meta(smem, meta, __ldg(meta + M_SMEM));
  const int H = m[M_H], D = m[M_D], n_res = m[M_NRES], maxc = m[M_MAXC], buf = m[M_BUF];
  const int hd = H * D, cf = m[M_DIMS + 1];
  float* xs = smem + m[M_XS];
  float* eps = smem + m[M_EPS];
  float* stats = smem + m[M_STATS];
  for (int i = threadIdx.x; i < hd; i += NT) xs[i] = __ldg(x_init + (size_t)sample * hd + i);
  cg::this_cluster().sync();  // every CTA has started before any writes into its shared memory

  for (int si = 0; si < n_total; ++si) {
    float* in = smem;
    for (int i = threadIdx.x; i < hd; i += NT) {
      const int d = i % D, t = i / D;
      in[row_off(0, H, t, D) + d] = xs[i];
    }
    zero_halo<1>(in, H, D);
    __syncthreads();
    const float* y = cunet_body<1, float>(m, W, nullptr, smem, in, smem + buf, smem + 2 * buf,
                                          films + (size_t)si * n_res * n_samples * maxc,
                                          n_samples, sample, sample, stats, rank);
    const float* w1 = W + m[M_F1];
    const float* b1 = W + m[M_F1 + 1];
    for (int i = threadIdx.x; i < hd; i += NT) {  // final 1x1 conv
      const int d = i % D, t = i / D;
      const float* yr = y + row_off(0, H, t, cf);
      float acc = 0.f;
      for (int ci = 0; ci < cf; ++ci) acc = fmaf(yr[ci], __ldg(w1 + ci * D + d), acc);
      eps[i] = acc + __ldg(b1 + d);
    }
    // The next pass pushes into the two buffers other than `in` before its first cluster
    // barrier: when y is one of them, every CTA must have read it first.
    if (y != in) cg::this_cluster().sync();
    else __syncthreads();
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
  if (rank == 0)
    for (int i = threadIdx.x; i < hd; i += NT) out[(size_t)sample * hd + i] = xs[i];
  cg::this_cluster().sync();  // no CTA leaves while another may still write into it
}

// reserve_smem's record of the shared-memory limit set for the kernel on each device
static int smem_set[MAX_DEVICES];

extern "C" {

// Launches the chain, one cluster per sample, on `stream`; returns the CUDA error code
// (0 = launched).
int ddim_chain_launch(const float* W, const int* meta, int smem_bytes, const float* films,
                      const float* x_init, const float* coefs, float* out, int n_total,
                      int n_samples, void* stream) {
  cudaError_t e = reserve_smem(ddim_chain_kernel, smem_bytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  ddim_chain_kernel<<<CLUSTER * n_samples, NT, smem_bytes, (cudaStream_t)stream>>>(
      W, meta, films, x_init, coefs, out, n_total);
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters for one sample's cluster at smem_bytes of dynamic shared
// memory per CTA, into *n_clusters; returns the CUDA error code (0 = answered).
int ddim_chain_max_active_clusters(int smem_bytes, int* n_clusters) {
  *n_clusters = 0;
  cudaError_t e = reserve_smem(ddim_chain_kernel, smem_bytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER);
  config.blockDim = dim3(NT);
  config.dynamicSmemBytes = smem_bytes;  // the cluster shape is the kernel's __cluster_dims__
  return (int)cudaOccupancyMaxActiveClusters(n_clusters, (void*)ddim_chain_kernel, &config);
}

int ddim_chain_cluster_size(void) { return CLUSTER; }

const char* ddim_chain_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ddim_chain_meta_len(void) { return M_LEN; }

}  // extern "C"
