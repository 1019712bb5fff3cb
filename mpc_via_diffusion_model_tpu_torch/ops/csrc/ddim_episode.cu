// A distilled student's whole diffusion-MPC closed loop of one episode as ONE CUDA kernel for
// Hopper (sm_90a): n_steps replans, each the student's DDIM chain over K candidate plans,
// best-of-K selection, the stage cost and the plant step.
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_episode.py::
// make_fused_ddim_episode (pallas_call at fused_episode.py:392), the fast path of
// scripts/bench_deep_students.py. Per replan, in the JAX kernel's order
// (fused_episode.py:318-374):
//   ctx   = (x - cn_shift) * cn_scale                      affine normalize of the state
//   per step si of the times grid: film = mish([t_emb[si], ctx, 1]) @ Wf_r + bf_r, one
//         vector, since all K candidates share the context and the student runs the
//         conditional pass only; then for every candidate k the step of ddim_chain.cu:
//         recon = clip(sra x - srm eps, -1, 1), x = c1 recon + c2 x
//   then unnormalize, best-of-K, stage cost and plant step as the CFG episode does
//   (episode.cuh).
// The staged noise is (n_steps, K, H, D): each replan's initial draw, JAX's
// (n_steps, K * H, D) with the candidate axis kept.
//
// What bounds it on this card. At the flagship shapes one U-Net pass over one row-set is
// 18.2 MFLOP, so an 80-replan episode on the 1-step grid [23] at K = 1 is 1.46 GFLOP of
// conv FMAs (plus 68 kFLOP per step of in-kernel FiLM) against about 4 MB of weights read
// once: over the whole card, bound by operations (22 us at 67 TFLOP/s fp32). But every
// replan needs the state the last one left and one block does it all: at one SM's
// ~0.5 TFLOP/s the episode takes ~3 ms at best, and the time grows with K and with the
// length of the grid, since candidates and steps run one after another.
//
// What the design does about it: cfg_episode.cu's design with one row-set per candidate.
// grid = 1 block per episode; the replan, step and candidate loops run inside the block,
// every trip count fixed by the launch's arguments (no inter-block synchronisation, no
// cooperative launch, no spin-wait). It uses the episode kernels' shared-memory plan
// (ops/unet_pack.py): its one FiLM group takes the first n_res x max_c floats of the FiLM
// region and the first cond_dim of the mish(c_emb) region. As in cfg_episode.cu, the
// step's coefficients and the 1x1 conv's pointers are read after the body, where they are
// used. Spreading candidates over a cluster of blocks is later work.

#include "episode.cuh"

// t_embs (n_total, temb); noise (n_steps, K, H, D); coefs (n_total, 4) = sra, srm, c1, c2;
// consts (C_LEN); x0 (DX). Outputs: x_track (n_steps + 1, DX), u_track (n_steps, DU),
// costs (n_steps), chosen (n_steps) = index of the applied candidate, K when none was chosen.
__global__ void __launch_bounds__(NT, 1)
ddim_episode_kernel(const float* __restrict__ W, const int* __restrict__ meta,
                    const float* __restrict__ t_embs, const float* __restrict__ noise,
                    const float* __restrict__ coefs, const float* __restrict__ consts,
                    const float* __restrict__ x0, float* __restrict__ x_track,
                    float* __restrict__ u_track, float* __restrict__ costs,
                    int* __restrict__ chosen, int n_steps, int n_total, int K, int sel_h) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
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
    x_track[threadIdx.x] = __ldg(x0 + threadIdx.x);
  }
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    if (threadIdx.x < dctx)
      ctx[threadIdx.x] = __fmul_rn(__fsub_rn(xst[threadIdx.x], __ldg(consts + C_CN_SHIFT + threadIdx.x)),
                                   __ldg(consts + C_CN_SCALE + threadIdx.x));
    for (int i = threadIdx.x; i < khd; i += NT) cand[i] = __ldg(noise + (size_t)step * khd + i);
    __syncthreads();

    for (int si = 0; si < n_total; ++si) {
      // films (n_res, 1, max_c) of the one group [t_emb, ctx (, 1)]
      episode_films<1>(m, W, t_embs + (size_t)si * temb, ctx, mc, films);
      for (int k = 0; k < K; ++k) {
        float* xs = cand + (size_t)k * hd;
        float* in = smem;
        for (int i = threadIdx.x; i < hd; i += NT) {
          const int d = i % D, t = i / D;
          in[row_off(0, H, t, D) + d] = xs[i];
        }
        zero_halo<1>(in, H, D);
        __syncthreads();
        const float* y = unet_body<1>(m, W, smem, in, smem + buf, smem + 2 * buf, films, 1, 0, 0,
                                      stats);
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
    }

    episode_finish_replan(consts, cand, score, misc, K, sel_h, H, D, step, x_track, u_track,
                          costs, chosen);
  }
}

extern "C" {

// Launches one episode on `stream`; returns the CUDA error code (0 = launched).
int ddim_episode_launch(const float* W, const int* meta, int smem_bytes, const float* t_embs,
                        const float* noise, const float* coefs, const float* consts,
                        const float* x0, float* x_track, float* u_track, float* costs,
                        int* chosen, int n_steps, int n_total, int K, int sel_h, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(ddim_episode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  ddim_episode_kernel<<<1, NT, smem_bytes, (cudaStream_t)stream>>>(
      W, meta, t_embs, noise, coefs, consts, x0, x_track, u_track, costs, chosen, n_steps,
      n_total, K, sel_h);
  return (int)cudaGetLastError();
}

const char* ddim_episode_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ddim_episode_meta_len(void) { return M_LEN; }

int ddim_episode_consts_len(void) { return C_LEN; }

int ddim_episode_plant_dims(void) { return DX * 100 + DU; }

}  // extern "C"
