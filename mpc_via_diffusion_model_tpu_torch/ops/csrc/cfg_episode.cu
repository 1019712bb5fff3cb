// The whole CFG diffusion-MPC closed loop of one episode as ONE CUDA kernel for Hopper
// (sm_90a): n_steps replans, each a (T + tail)-step CFG DDPM chain over K candidate plans,
// best-of-K selection, the stage cost and the plant step.
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_episode.py::
// make_fused_cfg_episode (pallas_call at fused_episode.py:653), bench.py's default path.
// Per replan, in the JAX kernel's order (fused_episode.py:562-623):
//   ctx   = (map(x) - cn_shift) * cn_scale                 the state-to-condition map (the
//         identity, or the state and the scene's features in cfg_episode_quadrotor.cu), then
//         the affine normalize
//   per step si: films_g = mish([t_emb[si], ctx_g, bit_g]) @ Wf_r + bf_r for the two groups
//         g = cond (ctx, bit 1) and uncond (zeros, bit 0); then for every candidate k the
//         chain step of cfg_chain.cu on its conditional and unconditional rows
//   u_k   = clip(x_k, -1, 1) * u_scale + u_shift            unnormalize every plan
//   K > 1: each candidate rolls out selection_horizon plant steps from x, scored by the
//         selection cost (terminal cost only when the whole plan is scored); first-min
//         argmin as a one-hot: a NaN score leaves it all zeros, so u0 = sum_k 0 * u_k[0]
//   stage = sum_i (q_i x_i) x_i + (r u0) u0;  x <- plant.step(x, u0)
// The recon, CFG and posterior lines keep cfg_chain.cu's __fmul_rn / __fadd_rn order: the
// first step's coefficients are 1e6, so any other rounding shows up a millionfold.
// All K candidates of a replan share one context, so the 2K FiLM groups of the JAX kernel
// are two distinct vectors; the kernel computes those two once per step.
//
// What bounds it on this card. The chain is kernel 1's work once per candidate: at the
// flagship shapes 1.09 GFLOP per candidate and replan, 87 GFLOP for an 80-replan episode at
// K = 1, against about 4 MB of weights and 0.3 MB of staged noise per episode. Over the
// whole card it is bound by operations (87 GFLOP at 67 TFLOP/s fp32 = 1.3 ms). But every
// replan needs the state the last one left, every step of a chain the step before, and
// inside a U-Net pass every layer the one before: the work is a chain of small dependent
// layers (36 MFLOP per pass of both row-sets), which one SM runs at best at its ~0.5 TFLOP/s.
//
// What the design does about it: one episode is one thread-block cluster of CLUSTER = 8
// CTAs on 8 SMs (__cluster_dims__, grid = 8), and the U-Net body is split over them by
// output channel, one GroupNorm group per rank (unet_body_cluster.cuh): each rank computes an
// eighth of every conv and pushes its final slices into every CTA's shared memory, with two
// cluster barriers per residual block. Everything outside the body runs redundantly in
// every CTA, on the same replicated data in the same order, so the 8 CTAs hold bit-identical
// state and exchange nothing else: the affine normalize, the FiLM vectors (each rank's own
// channels only), the final 1x1 conv, the recon and posterior lines, the unnormalize,
// best-of-K, the stage cost and the plant step. Only rank 0 writes the tracks. The replan
// loop, the step loop and the candidate loop run inside the cluster, every trip count is
// fixed by the launch's arguments, and cluster barriers are the only synchronisation
// between CTAs (the hardware co-schedules a cluster's CTAs; no grid-wide sync, no
// cooperative launch, no spin-wait). Activations reuse the CFG chain's two-row-set plan
// (ops/unet_pack.py, metas[2]) in every CTA; the FiLM vectors of the current step (n_res x 2 x max_c), the K
// candidate chains (K x H x D), the state and the candidate scores sit beside it. Weights
// stay in device memory, served from L2. The step's coefficients and the 1x1 conv's
// pointers are read after the body, where they are used (read before it, they made the
// one-block episode 7% slower on the H100). K candidates still run one after another.
//
// cfg_episode_max_active_clusters answers cudaOccupancyMaxActiveClusters at the episode's
// shared memory: the wrapper refuses to launch when it is 0 (a card without clusters, or
// not enough shared memory for 8 CTAs at once).
//
// The in-kernel FiLM and the end of each replan (unnormalize, best-of-K, stage cost, plant
// step) are in episode.cuh, shared with ddim_episode.cu. The plant is episode.cuh's Plant: the
// swing-up cart-pole here, the linear cart-pole in cfg_episode_lmpc.cu and the quadrotor in
// cfg_episode_quadrotor.cu (with its safety-first Scorer and its Condition map), which include
// this file with another EPISODE_PLANT and declare their own entries.
//
// bf16 weights (the JAX builder's weights_dtype=jnp.bfloat16, bench.py's BENCH_BF16=1): the
// kernel is a template on the conv kernels' element type WT. cfg_episode_launch runs the float
// instantiation, cfg_episode_bf16_launch the __nv_bfloat16 one, which reads the conv kernels
// and the final 1x1 kernel from the bf16 copy Wh of the buffer and rounds each product's
// activation operand to bf16 (unet_body_cluster.cuh), as fused_episode.py:587 rounds y before
// the final 1x1 conv; the FiLM Dense weights stay fp32, as append_film_weights keeps them.
// Each entry has its own occupancy query; neither falls back to the other.
//
// The plan in turns (TURNS, cfg_episode_panda.cu at the panda arm's horizon 128, where the
// two-row-set plan needs 321,360 B per CTA at K = 1): each candidate's conditional and
// unconditional passes run one after the other through cunet_body<1> on one row-set's
// activations and skips (ops/unet_pack.py, metas["turns"]: 174,928 B per CTA at K = 1), with
// FiLM rows 0 and 1 of the step's (n_res, 2, max_c) table, each writing its own half of eps;
// cfg_chain.cu says why that is the same arithmetic and where the barriers stand. The FiLM of
// a step is still computed once, for both groups, before the candidates.
//
// The in-kernel draw (DRAW, the JAX builder's inkernel_noise, fused_episode.py:550-554): the
// noise argument is the episode's (2,) int32 seed, and every CTA computes each replan's x_T and
// each injected draw itself, counter-based (philox.cuh), where the staged kernel loads them:
// the normal at (replan s, draw j, candidate k, row t, channel d) is the Philox normal of the
// counter (s * (n_total + 1) + j, k, t, d), j = n_total the x_T draw, as the JAX kernel counts
// its draws (fused_episode.py:554, :599, :602). The replan loop then reads no noise table.
//
// clip_denoised (the JAX builder's, fused_episode.py:425, :596) is every entry's `clip`
// argument, not an instantiation: 0 leaves the CFG reconstruction unclipped. The unnormalize
// clip of the plans (episode.cuh) stays.

#include "episode.cuh"
#include "philox.cuh"
#include "unet_body_cluster.cuh"

#include <type_traits>

// W is the packed buffer with the body's conv kernels rank-major (cluster_weights), Wh its
// bf16 copy (read in the bf16 instantiation only; last, so that the float instantiation's
// other parameters keep their offsets). t_embs (n_total, temb); noise (n_steps, n_total + 1,
// K, H, D) with row n_total = x_T, or with DRAW the (2,) seed words of the draw; coefs (n_total, 5) = sra, srm, c1, c2, sigma * gate;
// consts (C_LEN); x0 (DX).
// Outputs: x_track (n_steps + 1, DX), u_track (n_steps, DU), costs (n_steps),
// chosen (n_steps) = index of the applied candidate, K when none was chosen. Rank 0 writes
// the outputs.
template <typename WT, bool TURNS, bool DRAW>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT, 1)
cfg_episode_kernel(const float* __restrict__ W, const int* __restrict__ meta,
                   const float* __restrict__ t_embs,
                   const std::conditional_t<DRAW, int, float>* __restrict__ noise,
                   const float* __restrict__ coefs, const float* __restrict__ consts,
                   const float* __restrict__ x0, float* __restrict__ x_track,
                   float* __restrict__ u_track, float* __restrict__ costs,
                   int* __restrict__ chosen, int n_steps, int n_total, int K, int sel_h,
                   float w, float wp1, int clip, const __nv_bfloat16* __restrict__ Wh) {
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

  if (threadIdx.x < DX) {
    xst[threadIdx.x] = __ldg(x0 + threadIdx.x);
    if (rank == 0) x_track[threadIdx.x] = __ldg(x0 + threadIdx.x);
  }
  cg::this_cluster().sync();  // every CTA has started before any writes into its shared memory

  // two row-sets in one pass, or (TURNS) one row-set in each of two passes
  constexpr int NB = TURNS ? 1 : 2, PASSES = TURNS ? 2 : 1;
  for (int step = 0; step < n_steps; ++step) {
    const float* nz_step = nullptr;
    uint32_t k0 = 0, k1 = 0;
    if constexpr (DRAW) {
      k0 = (uint32_t)__ldg(noise);
      k1 = (uint32_t)__ldg(noise + 1);
    } else {
      nz_step = noise + (size_t)step * (n_total + 1) * khd;
    }
    const int draw0 = step * (n_total + 1);  // the replan's first Philox counter (DRAW)
    episode_context(consts, xst, ctx, dctx);
    for (int i = threadIdx.x; i < khd; i += NT) {  // x_T of every candidate
      if constexpr (DRAW) {
        const int d = i % D, t = (i / D) % H, k = i / hd;
        cand[i] = philox_normal(draw0 + n_total, k, t, d, k0, k1);
      } else {
        cand[i] = __ldg(nz_step + (size_t)n_total * khd + i);
      }
    }
    __syncthreads();

    for (int si = 0; si < n_total; ++si) {
      // films (n_res, 2, max_c) of the two groups: [t_emb, ctx (, 1)] and [t_emb, 0 (, 0)]
      episode_films_rank<2>(m, W, t_embs + (size_t)si * temb, ctx, mc, films, rank, CLUSTER);
      for (int k = 0; k < K; ++k) {
        float* xs = cand + (size_t)k * hd;
        for (int g = 0; g < PASSES; ++g) {
          float* in = smem;
          for (int i = threadIdx.x; i < NB * hd; i += NT) {  // x once per row-set
            const int d = i % D, rr = i / D, b = rr / H, t = rr - b * H;
            in[row_off(b, H, t, D) + d] = xs[t * D + d];
          }
          zero_halo<NB>(in, H, D);
          __syncthreads();
          // FiLM row of row-set 0: the conditional group (the unconditional one in the second turn)
          const float* y = cunet_body<NB, WT>(m, W, Wh, smem, in, smem + buf, smem + 2 * buf,
                                              films, 2, g, 1, stats, rank);
          const WT* w1 = conv_weights<WT>(W, Wh) + m[M_F1];
          const float* b1 = W + m[M_F1 + 1];
          float* eg = eps + g * hd;  // this pass's half of eps (all of it on two row-sets)
          for (int i = threadIdx.x; i < NB * hd; i += NT) {  // final 1x1 conv
            const int d = i % D, rr = i / D, b = rr / H, t = rr - b * H;
            const float* yr = y + row_off(b, H, t, cf);
            float acc = 0.f;
            for (int ci = 0; ci < cf; ++ci)
              acc = fmaf(round_operand<WT>(yr[ci]), wload(w1 + ci * D + d), acc);
            eg[i] = acc + __ldg(b1 + d);
          }
          // The next pass pushes into the two buffers other than `in` before its first cluster
          // barrier: when y is one of them, every CTA must have read it first.
          if (y != in) cg::this_cluster().sync();
          else __syncthreads();
        }
        const float* cs = coefs + (size_t)si * 5;
        const float sra = __ldg(cs), srm = __ldg(cs + 1), c1 = __ldg(cs + 2), c2 = __ldg(cs + 3),
                    sg = __ldg(cs + 4);
        const float* nz = nullptr;
        if constexpr (!DRAW) nz = nz_step + ((size_t)si * K + k) * hd;
        for (int i = threadIdx.x; i < hd; i += NT) {
          const float x = xs[i];
          const float rc = __fsub_rn(__fmul_rn(sra, x), __fmul_rn(srm, eps[i]));
          const float ru = __fsub_rn(__fmul_rn(sra, x), __fmul_rn(srm, eps[hd + i]));
          float rec = __fsub_rn(__fmul_rn(wp1, rc), __fmul_rn(w, ru));
          if (clip) rec = fminf(fmaxf(rec, -1.f), 1.f);
          const float mean = __fadd_rn(__fmul_rn(c1, rec), __fmul_rn(c2, x));
          float z;
          if constexpr (DRAW) z = philox_normal(draw0 + si, k, i / D, i % D, k0, k1);
          else z = __ldg(nz + i);
          xs[i] = __fadd_rn(mean, __fmul_rn(sg, z));
        }
        __syncthreads();
      }
    }

    episode_finish_replan(consts, cand, score, misc, K, sel_h, H, D, step, x_track, u_track,
                          costs, chosen, rank == 0);
  }
  cg::this_cluster().sync();  // no CTA leaves while another may still write into it
}

// reserve_smem's record of the shared-memory limit set for each instantiation on each device,
// in an anonymous namespace: a template's static member of external linkage is one object in
// the whole process (the loader unifies it across libraries), and cfg_chain.cu,
// cfg_episode.cu, cfg_episode_lmpc.cu and cfg_episode_quadrotor.cu each need their own record
// of their own kernel.
namespace {
template <typename WT, bool TURNS, bool DRAW>
struct SmemSet {
  static int set[MAX_DEVICES];
};
template <typename WT, bool TURNS, bool DRAW>
int SmemSet<WT, TURNS, DRAW>::set[MAX_DEVICES];
}  // namespace

template <typename WT, bool TURNS = false, bool DRAW = false>
static int launch(const float* W, const __nv_bfloat16* Wh, const int* meta, int smem_bytes,
                  const float* t_embs, const std::conditional_t<DRAW, int, float>* noise,
                  const float* coefs, const float* consts, const float* x0, float* x_track,
                  float* u_track, float* costs, int* chosen, int n_steps, int n_total, int K,
                  int sel_h, float w, float wp1, int clip, void* stream) {
  cudaError_t e = reserve_smem(cfg_episode_kernel<WT, TURNS, DRAW>, smem_bytes,
                               SmemSet<WT, TURNS, DRAW>::set);
  if (e != cudaSuccess) return (int)e;
  cfg_episode_kernel<WT, TURNS, DRAW><<<CLUSTER, NT, smem_bytes, (cudaStream_t)stream>>>(
      W, meta, t_embs, noise, coefs, consts, x0, x_track, u_track, costs, chosen, n_steps,
      n_total, K, sel_h, w, wp1, clip, Wh);
  return (int)cudaGetLastError();
}

template <typename WT, bool TURNS = false, bool DRAW = false>
static int max_active_clusters(int smem_bytes, int* n_clusters) {
  *n_clusters = 0;
  cudaError_t e = reserve_smem(cfg_episode_kernel<WT, TURNS, DRAW>, smem_bytes,
                               SmemSet<WT, TURNS, DRAW>::set);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER);
  config.blockDim = dim3(NT);
  config.dynamicSmemBytes = smem_bytes;  // the cluster shape is the kernel's __cluster_dims__
  return (int)cudaOccupancyMaxActiveClusters(
      n_clusters, (void*)cfg_episode_kernel<WT, TURNS, DRAW>, &config);
}

// cfg_episode_lmpc.cu, cfg_episode_quadrotor.cu and cfg_episode_panda.cu include this file for
// another plant and declare their own entries.
#ifndef EPISODE_PLANT_ENTRIES
extern "C" {

// Launches one episode on `stream`; returns the CUDA error code (0 = launched).
int cfg_episode_launch(const float* W, const int* meta, int smem_bytes, const float* t_embs,
                       const float* noise, const float* coefs, const float* consts,
                       const float* x0, float* x_track, float* u_track, float* costs,
                       int* chosen, int n_steps, int n_total, int K, int sel_h, float w,
                       float wp1, int clip, void* stream) {
  return launch<float>(W, nullptr, meta, smem_bytes, t_embs, noise, coefs, consts, x0, x_track,
                       u_track, costs, chosen, n_steps, n_total, K, sel_h, w, wp1, clip, stream);
}

// The same with bf16 conv kernels: Wh is the bf16 copy of W (same element offsets).
int cfg_episode_bf16_launch(const float* W, const __nv_bfloat16* Wh, const int* meta,
                            int smem_bytes, const float* t_embs, const float* noise,
                            const float* coefs, const float* consts, const float* x0,
                            float* x_track, float* u_track, float* costs, int* chosen,
                            int n_steps, int n_total, int K, int sel_h, float w, float wp1, int clip,
                            void* stream) {
  return launch<__nv_bfloat16>(W, Wh, meta, smem_bytes, t_embs, noise, coefs, consts, x0,
                               x_track, u_track, costs, chosen, n_steps, n_total, K, sel_h, w,
                               wp1, clip, stream);
}

// cudaOccupancyMaxActiveClusters for one episode's cluster at smem_bytes of dynamic shared
// memory per CTA, into *n_clusters; returns the CUDA error code (0 = answered).
int cfg_episode_max_active_clusters(int smem_bytes, int* n_clusters) {
  return max_active_clusters<float>(smem_bytes, n_clusters);
}

int cfg_episode_bf16_max_active_clusters(int smem_bytes, int* n_clusters) {
  return max_active_clusters<__nv_bfloat16>(smem_bytes, n_clusters);
}

int cfg_episode_cluster_size(void) { return CLUSTER; }

int cfg_episode_bf16_cluster_size(void) { return CLUSTER; }

const char* cfg_episode_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* cfg_episode_bf16_error_string(int code) { return cfg_episode_error_string(code); }

int cfg_episode_meta_len(void) { return M_LEN; }

int cfg_episode_bf16_meta_len(void) { return M_LEN; }

int cfg_episode_consts_len(void) { return C_LEN; }

int cfg_episode_bf16_consts_len(void) { return C_LEN; }

int cfg_episode_plant_dims(void) { return DX * 100 + DU; }

int cfg_episode_bf16_plant_dims(void) { return DX * 100 + DU; }

}  // extern "C"
#endif  // EPISODE_PLANT_ENTRIES
