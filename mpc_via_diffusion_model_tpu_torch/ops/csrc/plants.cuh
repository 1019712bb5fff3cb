// Plants and costs of the episode kernel as device functions, one thread per call.
//
// The JAX episode kernel (mpc_via_diffusion_model_tpu/ops/fused_episode.py) traces any pure
// plant step into Mosaic (_kernel_safe_fn). CUDA cannot trace Python, so each plant the
// kernel runs is written out here, operation by operation in the order of the port's torch
// version, with round-to-nearest intrinsics so that nvcc contracts nothing into an FMA.
// sinf and cosf are the accurate library functions (no --use_fast_math).
#pragma once

#include <cuda_runtime.h>

// The 5-state swing-up cart-pole with the virtual angle state theta*
// (mpc_via_diffusion_model_tpu_torch/dynamics/cartpole.py), Euler forward at dt.
struct CartpoleSwingup {
  static constexpr int DX = 5;
  static constexpr int DU = 1;

  static __device__ void step(const float* x, const float* u, float dt, float* xn) {
    const float M_CART = 2.0f, M_POLE = 1.0f;
    const float M_TOTAL = 3.0f;            // M_CART + M_POLE
    const float MPLP = 1.0f;               // M_POLE * L_POLE
    const float MPG = 9.81f;               // M_POLE * G
    const float MTG = 29.43f;              // M_TOTAL * G
    const float MTLP = 29.43f;             // sic: the reference sets MTLP = M_TOTAL * G
    const float PI_F = 3.14159265358979323846f;
    const float PI_UNDER_2 = 0.63661977236758134308f;  // 2 / pi
    (void)M_CART;
    const float uu = u[0];
    const float s = sinf(x[2]), c = cosf(x[2]);
    const float x3sq = __fmul_rn(x[3], x[3]);
    // (MPLP * -s * x3^2 + MPG * s * c + u) / (M_TOTAL - M_POLE * c)^2
    const float den1 = __fsub_rn(M_TOTAL, __fmul_rn(M_POLE, c));
    const float num1 = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(MPLP, -s), x3sq),
                                           __fmul_rn(__fmul_rn(MPG, s), c)), uu);
    const float xd1 = __fdiv_rn(num1, __fmul_rn(den1, den1));
    // (-MPLP * s * c * x3^2 - MTG * s - c * u) / (MTLP - MPLP * c^2)
    const float num3 = __fsub_rn(__fsub_rn(__fmul_rn(__fmul_rn(__fmul_rn(-MPLP, s), c), x3sq),
                                           __fmul_rn(MTG, s)), __fmul_rn(c, uu));
    const float den3 = __fsub_rn(MTLP, __fmul_rn(MPLP, __fmul_rn(c, c)));
    const float xd3 = __fdiv_rn(num3, den3);
    // -(2 / pi) * (theta - pi) * theta_dot
    const float xd4 = __fmul_rn(__fmul_rn(-PI_UNDER_2, __fsub_rn(x[2], PI_F)), x[3]);
    xn[0] = __fadd_rn(x[0], __fmul_rn(x[1], dt));
    xn[1] = __fadd_rn(x[1], __fmul_rn(xd1, dt));
    xn[2] = __fadd_rn(x[2], __fmul_rn(x[3], dt));
    xn[3] = __fadd_rn(x[3], __fmul_rn(xd3, dt));
    xn[4] = __fadd_rn(x[4], __fmul_rn(xd4, dt));
  }
};

// The episode's reported stage cost, unrolled as the JAX kernel writes it
// (fused_episode.py:617-618): sum_i (q_i * x_i) * x_i, then + sum_j (r_j * u_j) * u_j.
template <int DX, int DU>
static __device__ float stage_cost_unrolled(const float* q, const float* r, const float* x,
                                            const float* u) {
  float sx = __fmul_rn(__fmul_rn(q[0], x[0]), x[0]);
  for (int i = 1; i < DX; ++i) sx = __fadd_rn(sx, __fmul_rn(__fmul_rn(q[i], x[i]), x[i]));
  float su = __fmul_rn(__fmul_rn(r[0], u[0]), u[0]);
  for (int j = 1; j < DU; ++j) su = __fadd_rn(su, __fmul_rn(__fmul_rn(r[j], u[j]), u[j]));
  return __fadd_rn(sx, su);
}

// QuadraticCost.stage, the candidate scorer: sum_i q_i x_i^2 + sum_j r_j u_j^2.
template <int DX, int DU>
static __device__ float quad_stage(const float* q, const float* r, const float* x,
                                   const float* u) {
  float sx = 0.f, su = 0.f;
  for (int i = 0; i < DX; ++i) sx = __fadd_rn(sx, __fmul_rn(q[i], __fmul_rn(x[i], x[i])));
  for (int j = 0; j < DU; ++j) su = __fadd_rn(su, __fmul_rn(r[j], __fmul_rn(u[j], u[j])));
  return __fadd_rn(sx, su);
}

// QuadraticCost.terminal: sum_i p_i x_i^2.
template <int DX>
static __device__ float quad_terminal(const float* p, const float* x) {
  float s = 0.f;
  for (int i = 0; i < DX; ++i) s = __fadd_rn(s, __fmul_rn(p[i], __fmul_rn(x[i], x[i])));
  return s;
}
