// The DDIM episode kernel, which ddim_episode.cu (the swing-up cart-pole) and
// ddim_episode_quadrotor.cu (the quadrotor, its safety-first scorer and the in-kernel draw)
// compile for their plants: a distilled student's whole diffusion-MPC closed loop of one
// episode as ONE CUDA kernel for Hopper (sm_90a): n_steps replans, each the student's DDIM
// chain over K candidate plans, best-of-K selection, the stage cost and the plant step.
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_episode.py::
// make_fused_ddim_episode (pallas_call at fused_episode.py:392), the fast path of
// scripts/bench_deep_students.py and scripts/bench_quadrotor_student.py. Per replan, in the JAX kernel's order
// (fused_episode.py:318-374):
//   ctx   = (map(x) - cn_shift) * cn_scale                 affine normalize of the state (the
//         Condition map is the identity in both entries)
//   per step si of the times grid: film = mish([t_emb[si], ctx, 1]) @ Wf_r + bf_r, one
//         vector, since all K candidates share the context and the student runs the
//         conditional pass only; then for every candidate k the step of ddim_chain.cu:
//         recon = clip(sra x - srm eps, -1, 1), x = c1 recon + c2 x
//   then unnormalize, best-of-K, stage cost and plant step as the CFG episode does
//   (episode.cuh).
// The staged noise is (n_steps, K, H, D): each replan's initial draw, JAX's
// (n_steps, K * H, D) with the candidate axis kept. With the in-kernel draw (the template's
// DRAW, JAX's inkernel_noise) every CTA computes each replan's draw itself from the episode's
// two seed words, counter-based (philox.cuh), in place of that load.
//
// What bounds it on this card. At the flagship shapes one U-Net pass over one row-set is
// 18.2 MFLOP, so an 80-replan episode on the 1-step grid [23] at K = 1 is 1.46 GFLOP of
// conv FMAs (plus 68 kFLOP per step of in-kernel FiLM) against about 4 MB of weights read
// once: over the whole card, bound by operations (22 us at 67 TFLOP/s fp32). But every
// replan needs the state the last one left, every step of a chain the step before, and
// inside a U-Net pass every layer the one before: a chain of small dependent layers
// (18.2 MFLOP per pass), which one SM runs at best at its ~0.5 TFLOP/s, and the time grows
// with K and with the length of the grid, since candidates and steps run one after another.
//
// What the design does about it: cfg_episode.cu's design with one row-set per candidate.
// One episode is one thread-block cluster of CLUSTER = 8 CTAs on 8 SMs (__cluster_dims__,
// grid = 8 x n_episodes, the episode e = blockIdx.x / CLUSTER of a fleet, episode.cuh), and the
// U-Net body runs split over them by output channel, one GroupNorm group per rank
// (unet_body_cluster.cuh, cunet_body<1>): each rank computes an eighth of
// every conv and pushes its final slices into every CTA's shared memory. Everything
// outside the body runs redundantly in every CTA, on the same replicated data in the same
// order: the affine normalize, the FiLM vector (each rank's own channels only,
// episode_films_rank<1>), the pass's input, the final 1x1 conv, the DDIM lines and the end
// of each replan; only rank 0 writes the tracks. The replan, step and candidate loops run
// inside the cluster, every trip count fixed by the launch's arguments, and cluster
// barriers are the only synchronisation between CTAs (no grid-wide sync, no cooperative
// launch, no spin-wait). It uses the episode kernels' shared-memory plan on one row-set
// (ops/unet_pack.py, metas[1]) in every CTA: the activation buffers, the skips and eps hold one
// row-set, the FiLM region the one group's n_res x max_c floats and the mish(c_emb) region its
// cond_dim. At the panda arm's horizon 128 (ddim_episode_panda.cu) that plan is what fits one
// block: the two-row-set plan of the CFG episode would need 321,360 B per CTA at K = 1. Weights stay in device memory, served from L2, with the body's
// conv kernels rank-major (ops/unet_pack.py::cluster_weights). As in cfg_episode.cu, the
// step's coefficients and the 1x1 conv's pointers are read after the body, where they are
// used. K candidates still run one after another.
//
// Each entry's <entry>_max_active_clusters answers cudaOccupancyMaxActiveClusters at the
// episode's shared memory: the wrapper refuses to launch when it is 0.
//
// A fleet (the JAX builder's kernel under jax.vmap, scripts/bench_throughput.py:190-208): one
// launch of n_episodes clusters, each an independent episode on its own x0, noise and output
// rows (episode_offsets), every other argument shared; one episode is the fleet of one. Clusters
// never wait on each other: the cluster barrier stays the only synchronisation, and a fleet
// larger than the clusters that fit at once runs in waves as clusters finish.
//
// bf16 weights (the JAX builder's weights_dtype=jnp.bfloat16): the kernel is a template on the
// conv kernels' element type WT beside DRAW. The __nv_bfloat16 instantiation (the entries
// ddim_episode_bf16, ddim_episode_panda_bf16 and ddim_episode_quadrotor_bf16.cu's two) reads the body's conv kernels and the final 1x1
// kernel from the bf16 copy Wh of the buffer and rounds each product's activation operand to
// bf16 (unet_body_cluster.cuh), as fused_episode.py:339 rounds y before the final 1x1 conv; the
// FiLM Dense weights and every bias stay fp32. clip_denoised (fused_episode.py:346) is the
// launch's `clip` argument, not an instantiation: 0 leaves each reconstruction unclipped. The
// unnormalize clip of the plans (episode.cuh) stays.

#pragma once

#include <type_traits>

#include "episode.cuh"
#include "philox.cuh"
#include "unet_body_cluster.cuh"

// W is the packed buffer with the body's conv kernels rank-major (cluster_weights).
// t_embs (n_total, temb); noise (n_episodes, n_steps, K, H, D), or with DRAW the (n_episodes, 2)
// seed words of the in-kernel draw (philox.cuh); coefs (n_total, 4) = sra, srm, c1, c2; consts
// (C_LEN); x0 (n_episodes, DX). Outputs: x_track (n_episodes, n_steps + 1, DX), u_track
// (n_episodes, n_steps, DU), costs and chosen (n_episodes, n_steps), chosen the index of the
// applied candidate, K when none was chosen. Cluster e reads and writes episode e's rows
// (episode_offsets); its rank 0 writes them. Wh is W's bf16 copy (read in the bf16
// instantiation only; last, so that the float instantiation's other parameters keep their
// offsets); clip: clip each reconstruction.
template <typename WT, bool DRAW>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT, 1)
ddim_episode_kernel(const float* __restrict__ W, const int* __restrict__ meta,
                    const float* __restrict__ t_embs,
                    const std::conditional_t<DRAW, int, float>* __restrict__ noise,
                    const float* __restrict__ coefs, const float* __restrict__ consts,
                    const float* __restrict__ x0, float* __restrict__ x_track,
                    float* __restrict__ u_track, float* __restrict__ costs,
                    int* __restrict__ chosen, int n_steps, int n_total, int K, int sel_h,
                    int clip, const __nv_bfloat16* __restrict__ Wh) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rank = (int)cg::this_cluster().block_rank();
  const int ep_meta = __ldg(meta + M_EP_SMEM);
  const int* m = load_meta(smem, meta, ep_meta);
  const int H = m[M_H], D = m[M_D], buf = m[M_BUF];
  const int temb = m[M_TEMB], dctx = m[M_CTX];
  const int hd = H * D, khd = K * hd, cf = m[M_DIMS + 1];
  float* eps = smem + m[M_EPS];
  float* stats = smem + m[M_STATS];
  float* films = smem + m[M_EP_FILM];
  float* mc = smem + m[M_EP_MC];
  float* misc = smem + m[M_EP_MISC];
  float* xst = misc + X_STATE;
  float* ctx = misc + X_CTX;
  float* cand = smem + ep_meta + ((M_LEN + 3) / 4) * 4;  // (K, H, D) chains, then plans
  float* score = cand + ((khd + 3) / 4) * 4;            // (K,) candidate scores
  {  // this cluster's episode of the fleet
    const EpisodeOffsets o = episode_offsets((int)blockIdx.x / CLUSTER, n_steps,
                                             DRAW ? (size_t)2 : (size_t)n_steps * khd);
    x0 += o.x0;
    noise += o.noise;
    x_track += o.x_track;
    u_track += o.u_track;
    costs += o.costs;
    chosen += o.chosen;
  }

  if (threadIdx.x < DX) {
    xst[threadIdx.x] = __ldg(x0 + threadIdx.x);
    if (rank == 0) x_track[threadIdx.x] = __ldg(x0 + threadIdx.x);
  }
  cg::this_cluster().sync();  // every CTA has started before any writes into its shared memory

  for (int step = 0; step < n_steps; ++step) {
    episode_context(consts, xst, ctx, dctx);
    if constexpr (DRAW) {  // every CTA draws the same values (philox.cuh)
      const uint32_t k0 = (uint32_t)__ldg(noise), k1 = (uint32_t)__ldg(noise + 1);
      for (int i = threadIdx.x; i < khd; i += NT) {
        const int d = i % D, t = (i / D) % H, k = i / hd;
        cand[i] = philox_normal(step, k, t, d, k0, k1);
      }
    } else {
      for (int i = threadIdx.x; i < khd; i += NT) cand[i] = __ldg(noise + (size_t)step * khd + i);
    }
    __syncthreads();

    for (int si = 0; si < n_total; ++si) {
      // films (n_res, 1, max_c) of the one group [t_emb, ctx (, 1)], the rank's channels
      episode_films_rank<1>(m, W, t_embs + (size_t)si * temb, ctx, mc, films, rank, CLUSTER);
      for (int k = 0; k < K; ++k) {
        float* xs = cand + (size_t)k * hd;
        float* in = smem;
        for (int i = threadIdx.x; i < hd; i += NT) {
          const int d = i % D, t = i / D;
          in[row_off(0, H, t, D) + d] = xs[i];
        }
        zero_halo<1>(in, H, D);
        __syncthreads();
        const float* y = cunet_body<1, WT>(m, W, Wh, smem, in, smem + buf, smem + 2 * buf,
                                           films, 1, 0, 0, stats, rank);
        const WT* w1 = conv_weights<WT>(W, Wh) + m[M_F1];
        const float* b1 = W + m[M_F1 + 1];
        for (int i = threadIdx.x; i < hd; i += NT) {  // final 1x1 conv
          const int d = i % D, t = i / D;
          const float* yr = y + row_off(0, H, t, cf);
          float acc = 0.f;
          for (int ci = 0; ci < cf; ++ci)
            acc = fmaf(round_operand<WT>(yr[ci]), wload(w1 + ci * D + d), acc);
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
          if (clip) rec = fminf(fmaxf(rec, -1.f), 1.f);
          xs[i] = __fadd_rn(__fmul_rn(c1, rec), __fmul_rn(c2, x));
        }
        __syncthreads();
      }
    }

    episode_finish_replan(consts, cand, score, misc, K, sel_h, H, D, step, x_track, u_track,
                          costs, chosen, rank == 0);
  }
  cg::this_cluster().sync();  // no CTA leaves while another may still write into it
}

// reserve_smem's record of the shared-memory limit set for each instantiation of the kernel
// on each device, in an anonymous namespace: a template's static member of external linkage
// is one object in the whole process (the loader unifies it across libraries), and
// ddim_episode.cu and ddim_episode_quadrotor.cu each need their own record of their own kernel.
namespace {
template <typename WT, bool DRAW>
struct SmemSet {
  static int set[MAX_DEVICES];
};
template <typename WT, bool DRAW>
int SmemSet<WT, DRAW>::set[MAX_DEVICES];
}  // namespace

// Launches a fleet of n_episodes episodes, one cluster each, on `stream`; returns the CUDA error
// code (0 = launched).
template <typename WT, bool DRAW>
static int launch(const float* W, const __nv_bfloat16* Wh, const int* meta, int smem_bytes,
                  const float* t_embs, const std::conditional_t<DRAW, int, float>* noise,
                  const float* coefs, const float* consts, const float* x0, float* x_track,
                  float* u_track, float* costs, int* chosen, int n_steps, int n_total, int K,
                  int sel_h, int clip, int n_episodes, void* stream) {
  if (n_episodes < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      reserve_smem(ddim_episode_kernel<WT, DRAW>, smem_bytes, SmemSet<WT, DRAW>::set);
  if (e != cudaSuccess) return (int)e;
  ddim_episode_kernel<WT, DRAW><<<CLUSTER * n_episodes, NT, smem_bytes, (cudaStream_t)stream>>>(
      W, meta, t_embs, noise, coefs, consts, x0, x_track, u_track, costs, chosen, n_steps,
      n_total, K, sel_h, clip, Wh);
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters for one episode's cluster at smem_bytes of dynamic shared
// memory per CTA, into *n_clusters; returns the CUDA error code (0 = answered).
template <typename WT, bool DRAW>
static int max_active_clusters(int smem_bytes, int* n_clusters) {
  *n_clusters = 0;
  cudaError_t e =
      reserve_smem(ddim_episode_kernel<WT, DRAW>, smem_bytes, SmemSet<WT, DRAW>::set);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER);
  config.blockDim = dim3(NT);
  config.dynamicSmemBytes = smem_bytes;  // the cluster shape is the kernel's __cluster_dims__
  return (int)cudaOccupancyMaxActiveClusters(n_clusters, (void*)ddim_episode_kernel<WT, DRAW>,
                                             &config);
}

// Each entry's C interface besides <entry>_launch: the occupancy query, the cluster size, the
// error text, the meta and consts lengths and the plant's dimensions.
#define DDIM_EPISODE_QUERIES(ENTRY, WT_, DRAW_)                                               \
  int ENTRY##_max_active_clusters(int smem_bytes, int* n_clusters) {                          \
    return max_active_clusters<WT_, DRAW_>(smem_bytes, n_clusters);                           \
  }                                                                                           \
  int ENTRY##_cluster_size(void) { return CLUSTER; }                                          \
  const char* ENTRY##_error_string(int code) {                                                \
    return cudaGetErrorString((cudaError_t)code);                                             \
  }                                                                                           \
  int ENTRY##_meta_len(void) { return M_LEN; }                                                \
  int ENTRY##_consts_len(void) { return C_LEN; }                                              \
  int ENTRY##_plant_dims(void) { return DX * 100 + DU; }

// An entry of the float weights: <ENTRY>_launch runs a fleet of n_episodes episodes on `stream`
// and returns the CUDA error code (0 = launched); with DRAW_ the noise is the (n_episodes, 2) seed
// words. Then the entry's queries.
#define DDIM_EPISODE_ENTRY(ENTRY, DRAW_)                                                      \
  int ENTRY##_launch(const float* W, const int* meta, int smem_bytes, const float* t_embs,    \
                     const std::conditional_t<DRAW_, int, float>* noise, const float* coefs,  \
                     const float* consts, const float* x0, float* x_track, float* u_track,   \
                     float* costs, int* chosen, int n_steps, int n_total, int K, int sel_h,   \
                     int clip, int n_episodes, void* stream) {                                \
    return launch<float, DRAW_>(W, nullptr, meta, smem_bytes, t_embs, noise, coefs, consts,  \
                                x0, x_track, u_track, costs, chosen, n_steps, n_total, K,    \
                                sel_h, clip, n_episodes, stream);                             \
  }                                                                                           \
  DDIM_EPISODE_QUERIES(ENTRY, float, DRAW_)

// The same with bf16 conv kernels: Wh is the bf16 copy of W (same element offsets).
#define DDIM_EPISODE_BF16_ENTRY(ENTRY, DRAW_)                                                 \
  int ENTRY##_launch(const float* W, const __nv_bfloat16* Wh, const int* meta, int smem_bytes, \
                     const float* t_embs, const std::conditional_t<DRAW_, int, float>* noise, \
                     const float* coefs, const float* consts, const float* x0,                \
                     float* x_track, float* u_track, float* costs, int* chosen, int n_steps,  \
                     int n_total, int K, int sel_h, int clip, int n_episodes, void* stream) { \
    return launch<__nv_bfloat16, DRAW_>(W, Wh, meta, smem_bytes, t_embs, noise, coefs,       \
                                        consts, x0, x_track, u_track, costs, chosen, n_steps, \
                                        n_total, K, sel_h, clip, n_episodes, stream);         \
  }                                                                                           \
  DDIM_EPISODE_QUERIES(ENTRY, __nv_bfloat16, DRAW_)
