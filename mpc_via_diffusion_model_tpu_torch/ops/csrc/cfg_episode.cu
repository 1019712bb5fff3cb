// The whole CFG diffusion-MPC closed loop of one episode as ONE CUDA kernel for Hopper
// (sm_90a): n_steps replans, each a (T + tail)-step CFG DDPM chain over K candidate plans,
// best-of-K selection, the stage cost and the plant step.
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_episode.py::
// make_fused_cfg_episode (pallas_call at fused_episode.py:653), bench.py's default path.
// Per replan, in the JAX kernel's order (fused_episode.py:562-623):
//   ctx   = (x - cn_shift) * cn_scale                      affine normalize of the state
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
// replan needs the state the last one left, every step of a chain the step before, and one
// block does it all: at one SM's ~0.5 TFLOP/s an episode takes 170 ms at best, and the
// kernel's time grows with K, since candidates run one after another.
//
// What the design does about it: the simple design first. grid = 1 block per episode; the
// replan loop, the step loop and the candidate loop run inside the block, and every trip
// count is fixed by the launch's arguments (no inter-block synchronisation, no cooperative
// launch, no spin-wait). Activations reuse the chain kernel's shared-memory plan; the FiLM
// vectors of the current step (n_res x 2 x max_c), the K candidate chains (K x H x D), the
// state and the candidate scores sit beside it. Weights stay in device memory, served from
// L2. A thread has 128 registers (512 threads, one block per SM), and the U-Net body's conv
// loops need them: so the loops above the body keep little live across it, and the step's
// coefficients and the 1x1 conv's pointers are read after the body, where they are used
// (read before it, they made the episode take 18.9 instead of 17.7 ms per replan on the
// H100; moving the body into a non-inlined function made it slower still, its
// shared-memory accesses then going through generic pointers). Spreading candidates over a
// cluster of blocks, with the plans in distributed shared memory, is later work.
//
// The in-kernel FiLM and the end of each replan (unnormalize, best-of-K, stage cost, plant
// step) are in episode.cuh, shared with ddim_episode.cu.

#include "episode.cuh"

// t_embs (n_total, temb); noise (n_steps, n_total + 1, K, H, D) with row n_total = x_T;
// coefs (n_total, 5) = sra, srm, c1, c2, sigma * gate; consts (C_LEN); x0 (DX).
// Outputs: x_track (n_steps + 1, DX), u_track (n_steps, DU), costs (n_steps),
// chosen (n_steps) = index of the applied candidate, K when none was chosen.
__global__ void __launch_bounds__(NT, 1)
cfg_episode_kernel(const float* __restrict__ W, const int* __restrict__ meta,
                   const float* __restrict__ t_embs, const float* __restrict__ noise,
                   const float* __restrict__ coefs, const float* __restrict__ consts,
                   const float* __restrict__ x0, float* __restrict__ x_track,
                   float* __restrict__ u_track, float* __restrict__ costs,
                   int* __restrict__ chosen, int n_steps, int n_total, int K, int sel_h,
                   float w, float wp1) {
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
    const float* nz_step = noise + (size_t)step * (n_total + 1) * khd;
    if (threadIdx.x < dctx)
      ctx[threadIdx.x] = __fmul_rn(__fsub_rn(xst[threadIdx.x], __ldg(consts + C_CN_SHIFT + threadIdx.x)),
                                   __ldg(consts + C_CN_SCALE + threadIdx.x));
    for (int i = threadIdx.x; i < khd; i += NT) cand[i] = __ldg(nz_step + (size_t)n_total * khd + i);
    __syncthreads();

    for (int si = 0; si < n_total; ++si) {
      // films (n_res, 2, max_c) of the two groups: [t_emb, ctx (, 1)] and [t_emb, 0 (, 0)]
      episode_films<2>(m, W, t_embs + (size_t)si * temb, ctx, mc, films);
      for (int k = 0; k < K; ++k) {
        float* xs = cand + (size_t)k * hd;
        float* in = smem;
        for (int i = threadIdx.x; i < 2 * hd; i += NT) {  // x twice: cond rows, uncond rows
          const int d = i % D, rr = i / D, b = rr / H, t = rr - b * H;
          in[row_off(b, H, t, D) + d] = xs[t * D + d];
        }
        zero_halo<2>(in, H, D);
        __syncthreads();
        const float* y = unet_body<2>(m, W, smem, in, smem + buf, smem + 2 * buf, films, 2, 0, 1,
                                      stats);
        const float* w1 = W + m[M_F1];
        const float* b1 = W + m[M_F1 + 1];
        for (int i = threadIdx.x; i < 2 * hd; i += NT) {  // final 1x1 conv
          const int d = i % D, rr = i / D, b = rr / H, t = rr - b * H;
          const float* yr = y + row_off(b, H, t, cf);
          float acc = 0.f;
          for (int ci = 0; ci < cf; ++ci) acc = fmaf(yr[ci], __ldg(w1 + ci * D + d), acc);
          eps[i] = acc + __ldg(b1 + d);
        }
        __syncthreads();
        const float* cs = coefs + (size_t)si * 5;
        const float sra = __ldg(cs), srm = __ldg(cs + 1), c1 = __ldg(cs + 2), c2 = __ldg(cs + 3),
                    sg = __ldg(cs + 4);
        const float* nz = nz_step + ((size_t)si * K + k) * hd;
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
    }

    episode_finish_replan(consts, cand, score, misc, K, sel_h, H, D, step, x_track, u_track,
                          costs, chosen);
  }
}

extern "C" {

// Launches one episode on `stream`; returns the CUDA error code (0 = launched).
int cfg_episode_launch(const float* W, const int* meta, int smem_bytes, const float* t_embs,
                       const float* noise, const float* coefs, const float* consts,
                       const float* x0, float* x_track, float* u_track, float* costs,
                       int* chosen, int n_steps, int n_total, int K, int sel_h, float w,
                       float wp1, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(cfg_episode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cfg_episode_kernel<<<1, NT, smem_bytes, (cudaStream_t)stream>>>(
      W, meta, t_embs, noise, coefs, consts, x0, x_track, u_track, costs, chosen, n_steps,
      n_total, K, sel_h, w, wp1);
  return (int)cudaGetLastError();
}

const char* cfg_episode_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int cfg_episode_meta_len(void) { return M_LEN; }

int cfg_episode_consts_len(void) { return C_LEN; }

int cfg_episode_plant_dims(void) { return DX * 100 + DU; }

}  // extern "C"
