// What the two episode kernels, cfg_episode.cu and ddim_episode.cu, share: the plant, the
// consts and shared-memory layouts, the in-kernel FiLM of one denoising step and the end of
// a replan (unnormalize, best-of-K, stage cost, plant step).
//
// Port of the parts of mpc_via_diffusion_model_tpu/ops/fused_episode.py that
// make_fused_cfg_episode and make_fused_ddim_episode have in common (their replan bodies,
// fused_episode.py:562-623 and :318-374).
#pragma once

#include "plants.cuh"
#include "unet_body.cuh"

typedef CartpoleSwingup Plant;
#define DX Plant::DX
#define DU Plant::DU

// consts layout (ops/fused_episode.py): normalizer affines, reported and selection costs, dt
#define C_CN_SHIFT 0
#define C_CN_SCALE (C_CN_SHIFT + DX)
#define C_UN_SHIFT (C_CN_SCALE + DX)
#define C_UN_SCALE (C_UN_SHIFT + DU)
#define C_Q (C_UN_SCALE + DU)
#define C_R (C_Q + DX)
#define C_SQ (C_R + DU)
#define C_SR (C_SQ + DX)
#define C_SP (C_SR + DU)
#define C_DT (C_SP + DX)
#define C_LEN (C_DT + 1)

// misc region of shared memory (M_EP_MISC)
#define X_STATE 0
#define X_CTX 8
#define X_U0 16
#define X_BEST 24
#define MISC_LEN 32

// FiLM biases of one denoising step for G groups, into films (n_res, G, max_c) via mc
// (G, cond_dim): group 0 is [t_emb, ctx, 1], group 1 (the CFG episode's unconditional
// rows) [t_emb, 0, 0]; the trailing bit exists for cfg_indicator models only. Each
// ResidualTemporalBlock's Dense is mish(c_emb) @ Wf_r + bf_r; channels past its width are 0.
template <int G>
static __device__ void episode_films(const int* m, const float* __restrict__ W,
                                     const float* __restrict__ t_emb, const float* ctx,
                                     float* mc, float* films) {
  const int n_res = m[M_NRES], maxc = m[M_MAXC];
  const int cond = m[M_COND], temb = m[M_TEMB], dctx = m[M_CTX];
  for (int i = threadIdx.x; i < G * cond; i += NT) {
    const int g = i / cond, j = i - g * cond;
    float v;
    if (j < temb) v = __ldg(t_emb + j);
    else if (j < temb + dctx) v = g == 0 ? ctx[j - temb] : 0.f;
    else v = g == 0 ? 1.f : 0.f;  // the context-present bit (cfg_indicator models)
    mc[i] = mish_f(v);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_res * G * maxc; i += NT) {
    const int ch = i % maxc, rg = i / maxc, g = rg % G, r = rg / G;
    float acc = 0.f;
    if (ch < m[M_RES + r * RES_STRIDE + R_COUT]) {
      acc = __ldg(W + m[M_FB] + (size_t)r * maxc + ch);
      const float* fw = W + m[M_FW] + (size_t)r * cond * maxc + ch;
      for (int j = 0; j < cond; ++j) acc = fmaf(mc[g * cond + j], __ldg(fw + (size_t)j * maxc), acc);
    }
    films[i] = acc;
  }
  __syncthreads();
}

// The end of one replan, once the K normalized plans (K, H, D) are in cand, in the JAX
// episodes' order:
//   u_k   = clip(x_k, -1, 1) * u_scale + u_shift            unnormalize every plan
//   K > 1: each candidate rolls out sel_h plant steps from the state, scored by the
//         selection cost (terminal cost only when the whole plan is scored); first-min
//         argmin as a one-hot: a NaN score leaves it all zeros, so u0 = sum_k 0 * u_k[0]
//   stage = sum_i (q_i x_i) x_i + (r u0) u0;  x <- plant.step(x, u0)
// and writes the step's row of the tracks.
static __device__ void episode_finish_replan(
    const float* __restrict__ consts, float* cand, float* score, float* misc, int K, int sel_h,
    int H, int D, int step, float* __restrict__ x_track, float* __restrict__ u_track,
    float* __restrict__ costs, int* __restrict__ chosen) {
  float* xst = misc + X_STATE;
  float* u0 = misc + X_U0;
  const int hd = H * D, khd = K * hd;
  for (int i = threadIdx.x; i < khd; i += NT) {
    const int d = i % D;
    const float u = fminf(fmaxf(cand[i], -1.f), 1.f);
    cand[i] = __fadd_rn(__fmul_rn(u, __ldg(consts + C_UN_SCALE + d)),
                        __ldg(consts + C_UN_SHIFT + d));
  }
  __syncthreads();

  if (K > 1) {  // score every candidate by its rollout, one thread each
    for (int k = threadIdx.x; k < K; k += NT) {
      float xc[DX], xn[DX];
      for (int i = 0; i < DX; ++i) xc[i] = xst[i];
      float acc = 0.f;
      for (int t = 0; t < sel_h; ++t) {
        const float* u = cand + (size_t)k * hd + t * D;
        acc = __fadd_rn(acc, quad_stage<DX, DU>(consts + C_SQ, consts + C_SR, xc, u));
        Plant::step(xc, u, __ldg(consts + C_DT), xn);
        for (int i = 0; i < DX; ++i) xc[i] = xn[i];
      }
      if (sel_h == H) acc = __fadd_rn(acc, quad_terminal<DX>(consts + C_SP, xc));
      score[k] = acc;
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    int best = 0;
    if (K > 1) {
      // jnp.min propagates NaN; the first index equal to the min wins, none if it is NaN
      float mn = score[0];
      for (int k = 1; k < K; ++k) {
        const float s = score[k];
        mn = (isnan(mn) || isnan(s)) ? __int_as_float(0x7fc00000) : fminf(mn, s);
      }
      best = K;
      for (int k = 0; k < K; ++k)
        if (score[k] == mn) { best = k; break; }
      for (int j = 0; j < DU; ++j) {  // the one-hot product of the JAX kernels
        float acc = 0.f;
        for (int k = 0; k < K; ++k)
          acc = __fadd_rn(acc, __fmul_rn(k == best ? 1.f : 0.f, cand[(size_t)k * hd + j]));
        u0[j] = acc;
      }
    } else {
      for (int j = 0; j < DU; ++j) u0[j] = cand[j];
    }
    *reinterpret_cast<int*>(misc + X_BEST) = best;
    float xn[DX];
    const float stage = stage_cost_unrolled<DX, DU>(consts + C_Q, consts + C_R, xst, u0);
    Plant::step(xst, u0, __ldg(consts + C_DT), xn);
    for (int i = 0; i < DX; ++i) {
      xst[i] = xn[i];
      x_track[(size_t)(step + 1) * DX + i] = xn[i];
    }
    for (int j = 0; j < DU; ++j) u_track[(size_t)step * DU + j] = u0[j];
    costs[step] = stage;
    chosen[step] = best;
  }
  __syncthreads();
}
