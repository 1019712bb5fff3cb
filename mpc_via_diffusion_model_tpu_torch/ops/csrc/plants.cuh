// Plants and costs of the episode kernel as device functions, one thread per call.
//
// The JAX episode kernel (mpc_via_diffusion_model_tpu/ops/fused_episode.py) traces any pure
// plant step into Mosaic (_kernel_safe_fn). CUDA cannot trace Python, so each plant the
// kernel runs is written out here, operation by operation in the order of the port's torch
// version, with round-to-nearest intrinsics so that nvcc contracts nothing into an FMA.
// sinf and cosf are the accurate library functions (no --use_fast_math).
//
// A plant is a struct with its dimensions DX and DU, N_CONSTS, the number of fp32 constants it
// reads from the episode's consts table after dt (the Plant's device_consts on the host, as
// _kernel_safe_fn hoists a plant's captured arrays into kernel inputs), and
// step(x, u, pc, xn), where pc points at the table's dt, followed by those constants.
#pragma once

#include <cuda_runtime.h>

// The 5-state swing-up cart-pole with the virtual angle state theta*
// (mpc_via_diffusion_model_tpu_torch/dynamics/cartpole.py), Euler forward at dt.
struct CartpoleSwingup {
  static constexpr int DX = 5;
  static constexpr int DU = 1;
  static constexpr int N_CONSTS = 0;

  static __device__ void step(const float* x, const float* u, const float* __restrict__ pc,
                              float* xn) {
    const float dt = __ldg(pc);
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

// The 4-state linear cart-pole of the LMPC workload (dynamics/cartpole.py, cartpole_lmpc):
// x' = A_d x + B_d u, the zero-order hold at dt computed on the host. pc[1 .. 16] hold A_d
// row-major and pc[17 .. 20] B_d, in fp32. Each row in the torch step's order:
// ((a_i0 x0 + a_i1 x1) + a_i2 x2) + a_i3 x3, then + b_i u.
struct CartpoleLmpc {
  static constexpr int DX = 4;
  static constexpr int DU = 1;
  static constexpr int N_CONSTS = DX * DX + DX * DU;

  static __device__ void step(const float* x, const float* u, const float* __restrict__ pc,
                              float* xn) {
    const float* a = pc + 1;
    const float* b = a + DX * DX;
#pragma unroll
    for (int i = 0; i < DX; ++i) {
      float acc = __fmul_rn(__ldg(a + i * DX), x[0]);
#pragma unroll
      for (int j = 1; j < DX; ++j) acc = __fadd_rn(acc, __fmul_rn(__ldg(a + i * DX + j), x[j]));
#pragma unroll
      for (int j = 0; j < DU; ++j) acc = __fadd_rn(acc, __fmul_rn(__ldg(b + i * DU + j), u[j]));
      xn[i] = acc;
    }
  }
};

// The 12-state quadrotor (mpc_via_diffusion_model_tpu_torch/dynamics/quadrotor.py), Euler
// forward at dt: state (p, v, rpy, omega), controls (thrust, torques). pc[1] holds the mass m,
// pc[2 .. 4] the inertia (ixx, iyy, izz), in fp32. In the torch step's order: the ZYX body-z,
// acc = z_body * (thrust / m) - (0, 0, g), tth = sth / max(cth, 1e-3), the Euler-angle rates,
// the explicit cross product omega x (I omega), omega_dot = (tau - gyro) / I, x + xdot * dt.
// max(c, 1e-3) keeps a NaN as jnp.maximum does.
struct Quadrotor {
  static constexpr int DX = 12;
  static constexpr int DU = 4;
  static constexpr int N_CONSTS = 4;

  static __device__ void step(const float* x, const float* u, const float* __restrict__ pc,
                              float* xn) {
    const float dt = __ldg(pc), m = __ldg(pc + 1);
    const float in0 = __ldg(pc + 2), in1 = __ldg(pc + 3), in2 = __ldg(pc + 4);
    const float G = 9.81f;
    const float cphi = cosf(x[6]), sphi = sinf(x[6]);
    const float cth = cosf(x[7]), sth = sinf(x[7]);
    const float cpsi = cosf(x[8]), spsi = sinf(x[8]);
    const float tm = __fdiv_rn(u[0], m);
    const float z0 = __fadd_rn(__fmul_rn(__fmul_rn(cpsi, sth), cphi), __fmul_rn(spsi, sphi));
    const float z1 = __fsub_rn(__fmul_rn(__fmul_rn(spsi, sth), cphi), __fmul_rn(cpsi, sphi));
    const float z2 = __fmul_rn(cth, cphi);
    const float a0 = __fmul_rn(z0, tm), a1 = __fmul_rn(z1, tm);  // - 0.0: exact
    const float a2 = __fsub_rn(__fmul_rn(z2, tm), G);
    const float cs = cth < 1e-3f ? 1e-3f : cth;  // NaN stays NaN
    const float tth = __fdiv_rn(sth, cs);
    const float w0 = x[9], w1 = x[10], w2 = x[11];
    const float r0 = __fadd_rn(__fadd_rn(w0, __fmul_rn(__fmul_rn(sphi, tth), w1)),
                               __fmul_rn(__fmul_rn(cphi, tth), w2));
    const float r1 = __fsub_rn(__fmul_rn(cphi, w1), __fmul_rn(sphi, w2));
    const float r2 = __fdiv_rn(__fadd_rn(__fmul_rn(sphi, w1), __fmul_rn(cphi, w2)), cs);
    const float iw0 = __fmul_rn(in0, w0), iw1 = __fmul_rn(in1, w1), iw2 = __fmul_rn(in2, w2);
    const float g0 = __fsub_rn(__fmul_rn(w1, iw2), __fmul_rn(w2, iw1));
    const float g1 = __fsub_rn(__fmul_rn(w2, iw0), __fmul_rn(w0, iw2));
    const float g2 = __fsub_rn(__fmul_rn(w0, iw1), __fmul_rn(w1, iw0));
    const float xd[12] = {x[3], x[4], x[5], a0, a1, a2, r0, r1, r2,
                          __fdiv_rn(__fsub_rn(u[1], g0), in0), __fdiv_rn(__fsub_rn(u[2], g1), in1),
                          __fdiv_rn(__fsub_rn(u[3], g2), in2)};
#pragma unroll
    for (int i = 0; i < 12; ++i) xn[i] = __fadd_rn(x[i], __fmul_rn(xd[i], dt));
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

// The episode kernels' candidate scorers (episode.cuh, EPISODE_SCORER). Each reads the
// selection cost's diagonals q, r, p from the consts table (C_SQ, C_SR, C_SP) and its own
// N_CONSTS constants from sc, which follow the plant's in that table.

// QuadraticCost.stage and .terminal.
template <int DX, int DU>
struct QuadScorer {
  static constexpr int N_CONSTS = 0;

  static __device__ __forceinline__ float stage(const float* q, const float* r, const float* sc,
                                                const float* x, const float* u) {
    return quad_stage<DX, DU>(q, r, x, u);
  }

  static __device__ __forceinline__ float terminal(const float* p, const float* sc,
                                                   const float* x) {
    return quad_terminal<DX>(p, x);
  }
};

// The quadrotor task's safety-first selection cost (dynamics/quadrotor.py, SafetyFirstCost;
// the JAX package's scripts/quadrotor_task.py::make_select_cost), term by term in its order:
//   stage    = (quad_stage(x, 0 du) + factor * sum_j du_j^2) + hinge(x),  du = u - u_hover
//   terminal = quad_terminal(x) + hinge(x)
//   hinge(x) = sum_j (weight * pen_j) * pen_j,  pen_j = max(r_j - |p - c_j|, 0)
// with |p - c_j| = sqrt(((p0 - c0)^2 + (p1 - c1)^2) + (p2 - c2)^2) and r_j the radii already
// inflated by the margin. sc: u_hover (DU), factor, weight, the centers (N_OBS, 3) row-major,
// the radii (N_OBS).
template <int DX, int DU, int N_OBS>
struct SafetyFirstScorer {
  static constexpr int N_CONSTS = DU + 2 + 4 * N_OBS;

  static __device__ float hinge(const float* __restrict__ sc, const float* x) {
    const float w = __ldg(sc + DU + 1);
    const float* c = sc + DU + 2;
    const float* rad = c + 3 * N_OBS;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < N_OBS; ++j) {
      const float d0 = __fsub_rn(x[0], __ldg(c + 3 * j));
      const float d1 = __fsub_rn(x[1], __ldg(c + 3 * j + 1));
      const float d2 = __fsub_rn(x[2], __ldg(c + 3 * j + 2));
      const float d = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                           __fmul_rn(d2, d2)));
      const float v = __fsub_rn(__ldg(rad + j), d);
      const float pen = v < 0.f ? 0.f : v;  // NaN stays NaN, as torch.clamp_min keeps it
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(w, pen), pen));
    }
    return acc;
  }

  static __device__ float stage(const float* q, const float* r, const float* __restrict__ sc,
                                const float* x, const float* u) {
    float du[DU], z[DU];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < DU; ++j) {
      du[j] = __fsub_rn(u[j], __ldg(sc + j));
      z[j] = __fmul_rn(du[j], 0.f);
      s = __fadd_rn(s, __fmul_rn(du[j], du[j]));
    }
    const float a = quad_stage<DX, DU>(q, r, x, z);
    return __fadd_rn(__fadd_rn(a, __fmul_rn(__ldg(sc + DU), s)), hinge(sc, x));
  }

  static __device__ float terminal(const float* p, const float* __restrict__ sc,
                                   const float* x) {
    return __fadd_rn(quad_terminal<DX>(p, x), hinge(sc, x));
  }
};

// The episode kernels' state-to-condition maps (episode.cuh, EPISODE_CONDITION), the
// counterparts of the JAX kernel's traced state_to_condition. A map is a struct with DC, the
// width of the raw context it makes of the DX-state, N_CONSTS, the number of fp32 constants it
// reads from the episode's consts table after the plant's (its device_consts on the host:
// control/conditions.py), and map(x, pc, i), entry i < DC of the raw context of the state x,
// with pc pointing at those constants. Each thread of the kernel computes one entry, then
// normalizes it.

// The identity (the JAX episodes' default): the context is the state.
template <int DX>
struct IdentityCondition {
  static constexpr int DC = DX;
  static constexpr int N_CONSTS = 0;

  static __device__ __forceinline__ float map(const float* x, const float* __restrict__ pc,
                                              int i) {
    return x[i];
  }
};

// The state followed by NF constant features (control/conditions.py, ConcatFeatures):
// ctx_raw = [x, features], the features read from pc. The scene-conditioned quadrotor
// student's 12 scene features ride here, so that another scene is another table, not another
// build.
template <int DX, int NF>
struct ConcatFeatures {
  static constexpr int DC = DX + NF;
  static constexpr int N_CONSTS = NF;

  static __device__ __forceinline__ float map(const float* x, const float* __restrict__ pc,
                                              int i) {
    return i < DX ? x[i] : __ldg(pc + (i - DX));
  }
};
