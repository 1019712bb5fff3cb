// What the two episode kernels, cfg_episode.cu and ddim_episode.cu, share: the plant, the
// consts and shared-memory layouts, the context of a replan (the state-to-condition map and
// the affine normalize), the in-kernel FiLM of one denoising step (each rank's channels of the
// cluster body) and the end of a replan (unnormalize, best-of-K, stage cost, plant step).
//
// Port of the parts of mpc_via_diffusion_model_tpu/ops/fused_episode.py that
// make_fused_cfg_episode and make_fused_ddim_episode have in common (their replan bodies,
// fused_episode.py:562-623 and :318-374).
#pragma once

#include "plants.cuh"
#include "unet_body.cuh"

// The plant of the episode: the swing-up cart-pole unless the source that includes this file
// names another of plants.cuh first (cfg_episode_lmpc.cu, ddim_episode_quadrotor.cu).
#ifndef EPISODE_PLANT
#define EPISODE_PLANT CartpoleSwingup
#endif
typedef EPISODE_PLANT Plant;
#define DX Plant::DX
#define DU Plant::DU

// The candidate scorer of best-of-K (plants.cuh): the selection QuadraticCost unless the
// source names another first (ddim_episode_quadrotor.cu: the quadrotor's safety-first cost).
#ifndef EPISODE_SCORER
#define EPISODE_SCORER QuadScorer<DX, DU>
#endif
typedef EPISODE_SCORER Scorer;

// The state-to-condition map (plants.cuh): the identity unless the source names another first
// (cfg_episode_quadrotor.cu: the state followed by the scene's features). DC is the width of
// the context, the model's context_dim.
#ifndef EPISODE_CONDITION
#define EPISODE_CONDITION IdentityCondition<DX>
#endif
typedef EPISODE_CONDITION Condition;
#define DC Condition::DC
static_assert(DC >= DX, "the context holds at least the state");

// consts layout (ops/fused_episode.py): normalizer affines (the condition's over DC), reported
// and selection costs, dt, the plant's own constants (Plant::N_CONSTS), the condition map's
// (Condition::N_CONSTS), then the scorer's (Scorer::N_CONSTS)
#define C_CN_SHIFT 0
#define C_CN_SCALE (C_CN_SHIFT + DC)
#define C_UN_SHIFT (C_CN_SCALE + DC)
#define C_UN_SCALE (C_UN_SHIFT + DU)
#define C_Q (C_UN_SCALE + DU)
#define C_R (C_Q + DX)
#define C_SQ (C_R + DU)
#define C_SR (C_SQ + DX)
#define C_SP (C_SR + DU)
#define C_DT (C_SP + DX)
#define C_CD (C_DT + 1 + Plant::N_CONSTS)
#define C_SC (C_CD + Condition::N_CONSTS)
#define C_LEN (C_SC + Scorer::N_CONSTS)

// misc region of shared memory (M_EP_MISC, ops/unet_pack.py::ep_misc_len(context_dim)): the
// state and the context, each in a slot of DC rounded up to 8, the first control and the
// choice (DU <= 8)
#define X_STATE 0
#define X_CTX (8 * ((DC + 7) / 8))
#define X_U0 (2 * X_CTX)
#define X_BEST (X_U0 + 8)
#define MISC_LEN (X_BEST + 8)
static_assert(DU <= 8, "the misc region holds at most 8 controls");

// The normalized context of the state xst into ctx, one thread per entry i < dctx (the
// model's context_dim, DC), in the JAX kernel's order (fused_episode.py:563-564):
//   ctx_i = (Condition::map(x)_i - cn_shift_i) * cn_scale_i
// The caller synchronises before ctx is read.
static __device__ __forceinline__ void episode_context(const float* __restrict__ consts,
                                                       const float* xst, float* ctx, int dctx) {
  if (threadIdx.x < dctx)
    ctx[threadIdx.x] =
        __fmul_rn(__fsub_rn(Condition::map(xst, consts + C_CD, threadIdx.x),
                            __ldg(consts + C_CN_SHIFT + threadIdx.x)),
                  __ldg(consts + C_CN_SCALE + threadIdx.x));
}

// mish(c_emb) of G groups into mc (G, cond_dim): group 0 is [t_emb, ctx, 1], group 1 (the
// CFG episode's unconditional rows) [t_emb, 0, 0]; the trailing bit exists for
// cfg_indicator models only.
template <int G>
static __device__ void episode_film_inputs(const int* m, const float* __restrict__ t_emb,
                                           const float* ctx, float* mc) {
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
}

// FiLM biases of one denoising step for G groups, into films (n_res, G, max_c) via mc
// (episode_film_inputs), for the cluster body (unet_body_cluster.cuh): each
// ResidualTemporalBlock's Dense is mish(c_emb) @ Wf_r + bf_r, and only the channels of each
// block that rank `rank` of n_ranks owns, [rank * cout / n_ranks, (rank + 1) * cout / n_ranks),
// are written; the rest of films is left as it is.
template <int G>
static __device__ void episode_films_rank(const int* m, const float* __restrict__ W,
                                          const float* __restrict__ t_emb, const float* ctx,
                                          float* mc, float* films, int rank, int n_ranks) {
  const int n_res = m[M_NRES], maxc = m[M_MAXC], cond = m[M_COND];
  episode_film_inputs<G>(m, t_emb, ctx, mc);
  const int per = maxc / n_ranks;  // the most channels a rank owns in one block
  for (int i = threadIdx.x; i < n_res * G * per; i += NT) {
    const int j = i % per, rg = i / per, g = rg % G, r = rg / G;
    const int nc = m[M_RES + r * RES_STRIDE + R_COUT] / n_ranks;
    if (j >= nc) continue;
    const int ch = rank * nc + j;
    float acc = __ldg(W + m[M_FB] + (size_t)r * maxc + ch);
    const float* fw = W + m[M_FW] + (size_t)r * cond * maxc + ch;
    for (int q = 0; q < cond; ++q) acc = fmaf(mc[g * cond + q], __ldg(fw + (size_t)q * maxc), acc);
    films[((size_t)r * G + g) * maxc + ch] = acc;
  }
  __syncthreads();
}

// The end of one replan, once the K normalized plans (K, H, D) are in cand, in the JAX
// episodes' order:
//   u_k   = clip(x_k, -1, 1) * u_scale + u_shift            unnormalize every plan
//   K > 1: each candidate rolls out sel_h plant steps from the state, scored by the
//         selection cost (Scorer; terminal cost only when the whole plan is scored); first-min
//         argmin as a one-hot: a NaN score leaves it all zeros, so u0 = sum_k 0 * u_k[0]
//   stage = sum_i (q_i x_i) x_i + (r u0) u0;  x <- plant.step(x, u0)
// (the plant reads dt and its constants from consts + C_DT) and, when `writer`, writes the
// step's row of the tracks. The CTAs of a cluster all hold the same plans and state and all
// run it, each updating its own state; one of them writes.
static __device__ void episode_finish_replan(
    const float* __restrict__ consts, float* cand, float* score, float* misc, int K, int sel_h,
    int H, int D, int step, float* __restrict__ x_track, float* __restrict__ u_track,
    float* __restrict__ costs, int* __restrict__ chosen, bool writer = true) {
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
        acc = __fadd_rn(acc, Scorer::stage(consts + C_SQ, consts + C_SR, consts + C_SC, xc, u));
        Plant::step(xc, u, consts + C_DT, xn);
        for (int i = 0; i < DX; ++i) xc[i] = xn[i];
      }
      if (sel_h == H) acc = __fadd_rn(acc, Scorer::terminal(consts + C_SP, consts + C_SC, xc));
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
    Plant::step(xst, u0, consts + C_DT, xn);
    for (int i = 0; i < DX; ++i) {
      xst[i] = xn[i];
      if (writer) x_track[(size_t)(step + 1) * DX + i] = xn[i];
    }
    if (writer) {
      for (int j = 0; j < DU; ++j) u_track[(size_t)step * DU + j] = u0[j];
      costs[step] = stage;
      chosen[step] = best;
    }
  }
  __syncthreads();
}
