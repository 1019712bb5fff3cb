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
// = 1.09 GFLOP against 4.2 MB of weights, FiLM table and noise. Over the whole card it is
// bound by operations (1.09 GFLOP at 67 TFLOP/s fp32 = 16 us). But the chain is
// sequential: step s+1 needs step s, and inside a step each layer needs the last, so one
// sample's work cannot spread over the card; on one SM (~0.5 TFLOP/s) it takes 2.1 ms at
// best, and the one-block kernel of the first slices took 17 ms.
//
// What the design does about it: cfg_episode.cu's body. Each sample is one thread-block
// cluster of CLUSTER = 8 CTAs on 8 SMs (__cluster_dims__, grid = 8 x n_samples, sample =
// blockIdx.x / CLUSTER), and the U-Net body is split over them by output channel, one
// GroupNorm group per rank (unet_body_cluster.cuh): each rank computes an eighth of every
// conv and pushes its final slices into every CTA's shared memory, with two cluster
// barriers per residual block. Everything outside the body runs redundantly in every CTA,
// on the same replicated data in the same order: the pass's input, the final 1x1 conv and
// the recon, CFG, clip and posterior lines. Only rank 0 writes the output. The step loop
// runs inside the cluster, its trip count fixed by the launch's arguments, and cluster
// barriers are the only synchronisation between CTAs (no grid-wide sync, no cooperative
// launch, no spin-wait). The FiLM table (n_total, n_res, 2B, max_c) comes from torch and
// is read from device memory; conditional rows are row `sample`, unconditional rows row
// n_samples + sample. Weights stay in device memory, served from L2, with the body's conv
// kernels rank-major (ops/unet_pack.py::cluster_weights). Activations use the one-block
// plan (unet_body.cuh's: three rotating buffers, the skips, x, eps and the GroupNorm
// statistics, about 96 KB at the flagship shapes) in every CTA.
//
// cfg_chain_max_active_clusters answers cudaOccupancyMaxActiveClusters at the chain's
// shared memory: the wrapper refuses to launch when it is 0.
//
// bf16 weights (the JAX builder's weights_dtype=jnp.bfloat16): the kernel is a template on
// the conv kernels' element type WT. cfg_chain_launch runs the float instantiation, and
// cfg_chain_bf16_launch the __nv_bfloat16 one, which reads the conv kernels and the final 1x1
// kernel from the bf16 copy Wh of the buffer and rounds each product's activation operand to
// bf16 (unet_body_cluster.cuh), as fused_denoise.py:106 rounds y before the final 1x1 conv.
// Each entry has its own occupancy query; neither falls back to the other.

#include "unet_body_cluster.cuh"

// W is the packed buffer with the body's conv kernels rank-major (cluster_weights), Wh its
// bf16 copy (read in the bf16 instantiation only; last, so that the float instantiation's
// other parameters keep their offsets). films (n_total, n_res, 2B, max_c); noise
// (n_total + 1, B, H, D) with row n_total = x_T; coefs (n_total, 5) = sra, srm, c1, c2,
// sigma * gate; out (B, H, D).
template <typename WT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT, 1)
cfg_chain_kernel(const float* __restrict__ W, const int* __restrict__ meta,
                 const float* __restrict__ films, const float* __restrict__ noise,
                 const float* __restrict__ coefs, float* __restrict__ out, int n_total,
                 float w, float wp1, const __nv_bfloat16* __restrict__ Wh) {
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
  const size_t noise_step = (size_t)n_samples * hd;
  for (int i = threadIdx.x; i < hd; i += NT)
    xs[i] = __ldg(noise + (size_t)n_total * noise_step + (size_t)sample * hd + i);
  cg::this_cluster().sync();  // every CTA has started before any writes into its shared memory

  for (int si = 0; si < n_total; ++si) {
    float* in = smem;
    for (int i = threadIdx.x; i < 2 * hd; i += NT) {  // x twice: cond rows, uncond rows
      const int d = i % D, rr = i / D, b = rr / H, t = rr - b * H;
      in[row_off(b, H, t, D) + d] = xs[t * D + d];
    }
    zero_halo<2>(in, H, D);
    __syncthreads();
    const float* y = cunet_body<2, WT>(m, W, Wh, smem, in, smem + buf, smem + 2 * buf,
                                   films + (size_t)si * n_res * 2 * n_samples * maxc,
                                   2 * n_samples, sample, n_samples + sample, stats, rank);
    const WT* w1 = conv_weights<WT>(W, Wh) + m[M_F1];
    const float* b1 = W + m[M_F1 + 1];
    for (int i = threadIdx.x; i < 2 * hd; i += NT) {  // final 1x1 conv
      const int d = i % D, rr = i / D, b = rr / H, t = rr - b * H;
      const float* yr = y + row_off(b, H, t, cf);
      float acc = 0.f;
      for (int ci = 0; ci < cf; ++ci)
        acc = fmaf(round_operand<WT>(yr[ci]), wload(w1 + ci * D + d), acc);
      eps[i] = acc + __ldg(b1 + d);
    }
    // The next pass pushes into the two buffers other than `in` before its first cluster
    // barrier: when y is one of them, every CTA must have read it first.
    if (y != in) cg::this_cluster().sync();
    else __syncthreads();
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
  if (rank == 0)
    for (int i = threadIdx.x; i < hd; i += NT) out[(size_t)sample * hd + i] = xs[i];
  cg::this_cluster().sync();  // no CTA leaves while another may still write into it
}

// reserve_smem's record of the shared-memory limit set for each instantiation on each device,
// in an anonymous namespace: a template's static member of external linkage is one object in
// the whole process (the loader unifies it across libraries), and cfg_chain.cu, cfg_episode.cu
// and cfg_episode_lmpc.cu each need their own record of their own kernel.
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
                  const float* films, const float* noise, const float* coefs, float* out,
                  int n_total, int n_samples, float w, float wp1, void* stream) {
  cudaError_t e = reserve_smem(cfg_chain_kernel<WT>, smem_bytes, SmemSet<WT>::set);
  if (e != cudaSuccess) return (int)e;
  cfg_chain_kernel<WT><<<CLUSTER * n_samples, NT, smem_bytes, (cudaStream_t)stream>>>(
      W, meta, films, noise, coefs, out, n_total, w, wp1, Wh);
  return (int)cudaGetLastError();
}

template <typename WT>
static int max_active_clusters(int smem_bytes, int* n_clusters) {
  *n_clusters = 0;
  cudaError_t e = reserve_smem(cfg_chain_kernel<WT>, smem_bytes, SmemSet<WT>::set);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER);
  config.blockDim = dim3(NT);
  config.dynamicSmemBytes = smem_bytes;  // the cluster shape is the kernel's __cluster_dims__
  return (int)cudaOccupancyMaxActiveClusters(n_clusters, (void*)cfg_chain_kernel<WT>, &config);
}

extern "C" {

// Launches the chain, one cluster per sample, on `stream`; returns the CUDA error code
// (0 = launched).
int cfg_chain_launch(const float* W, const int* meta, int smem_bytes, const float* films,
                     const float* noise, const float* coefs, float* out, int n_total,
                     int n_samples, float w, float wp1, void* stream) {
  return launch<float>(W, nullptr, meta, smem_bytes, films, noise, coefs, out, n_total,
                       n_samples, w, wp1, stream);
}

// The same with bf16 conv kernels: Wh is the bf16 copy of W (same element offsets).
int cfg_chain_bf16_launch(const float* W, const __nv_bfloat16* Wh, const int* meta,
                          int smem_bytes, const float* films, const float* noise,
                          const float* coefs, float* out, int n_total, int n_samples, float w,
                          float wp1, void* stream) {
  return launch<__nv_bfloat16>(W, Wh, meta, smem_bytes, films, noise, coefs, out, n_total,
                               n_samples, w, wp1, stream);
}

// cudaOccupancyMaxActiveClusters for one sample's cluster at smem_bytes of dynamic shared
// memory per CTA, into *n_clusters; returns the CUDA error code (0 = answered).
int cfg_chain_max_active_clusters(int smem_bytes, int* n_clusters) {
  return max_active_clusters<float>(smem_bytes, n_clusters);
}

int cfg_chain_bf16_max_active_clusters(int smem_bytes, int* n_clusters) {
  return max_active_clusters<__nv_bfloat16>(smem_bytes, n_clusters);
}

int cfg_chain_cluster_size(void) { return CLUSTER; }

int cfg_chain_bf16_cluster_size(void) { return CLUSTER; }

const char* cfg_chain_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* cfg_chain_bf16_error_string(int code) { return cfg_chain_error_string(code); }

int cfg_chain_meta_len(void) { return M_LEN; }

int cfg_chain_bf16_meta_len(void) { return M_LEN; }

}  // extern "C"
