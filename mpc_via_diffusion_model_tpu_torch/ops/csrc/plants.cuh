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

// The 7-DoF Franka Panda arm (mpc_via_diffusion_model_tpu_torch/dynamics/arm.py,
// panda_rbd_unrolled): state x = (q - q_ref (7), qd (7)), controls the joint torques (7). One
// step, in the torch step's order:
//   q = x[:7] + q_ref; the seven link transforms (R_i, P_i) at q
//   bias = RNE(q, qd, 0, g); column j of M = RNE(q, 0, e_j, 0); M = 0.5 (M + M^T)
//   rhs = (u - bias) - viscous qd; qdd = M^-1 rhs by the unrolled Cholesky solve
//   qd' = qd + qdd dt; q' = x[:7] + qd' dt
// RNE is panda_inverse_dynamics_unrolled: the outward pass of the angular velocity and
// acceleration, the linear acceleration and the link forces and moments, then the inward pass
// of the forces and moments, every cross product and 3-vector product written out in the
// torch version's order (zeros added where it adds them). The link transforms depend on q
// alone and are computed once for the eight RNE passes, as the torch version shares them.
// pc[1 ..] hold the link table (7 x a, cos alpha, sin alpha, -d sin alpha, d cos alpha), the
// masses (7), the COMs (7 x 3), the inertia tensors (7 x 3 x 3, row-major), the viscous gains
// (7) and q_ref (7), in fp32 (arm.py, panda_device_consts). The step is one thread's serial
// work (about 13,000 fp32 operations), kept out of line (__noinline__) so that its local arrays
// do not weigh on the registers of the kernel around it.
struct PandaRbd {
  static constexpr int DX = 14;
  static constexpr int DU = 7;
  static constexpr int N_CONSTS = 35 + 7 + 21 + 63 + 7 + 7;

  // the links' rotations R (7 x 9, row-major) and offsets P (7 x 3) at joint angles q
  static __device__ void links(const float* q, const float* __restrict__ lk, float* R, float* P) {
    for (int i = 0; i < 7; ++i) {
      const float* l = lk + 5 * i;
      const float ca = __ldg(l + 1), sa = __ldg(l + 2);
      const float cq = cosf(q[i]), sq = sinf(q[i]);
      float* r = R + 9 * i;
      r[0] = cq; r[1] = -sq; r[2] = 0.f;
      r[3] = __fmul_rn(sq, ca); r[4] = __fmul_rn(cq, ca); r[5] = __fsub_rn(0.f, sa);
      r[6] = __fmul_rn(sq, sa); r[7] = __fmul_rn(cq, sa); r[8] = __fadd_rn(0.f, ca);
      P[3 * i] = __fadd_rn(0.f, __ldg(l));
      P[3 * i + 1] = __fadd_rn(0.f, __ldg(l + 3));
      P[3 * i + 2] = __fadd_rn(0.f, __ldg(l + 4));
    }
  }

  static __device__ __forceinline__ void cross(const float* a, const float* b, float* o) {
    o[0] = __fsub_rn(__fmul_rn(a[1], b[2]), __fmul_rn(a[2], b[1]));
    o[1] = __fsub_rn(__fmul_rn(a[2], b[0]), __fmul_rn(a[0], b[2]));
    o[2] = __fsub_rn(__fmul_rn(a[0], b[1]), __fmul_rn(a[1], b[0]));
  }

  // r v (transposed: r^T v), each row's three products summed left to right
  static __device__ __forceinline__ void matvec(const float* r, const float* v, float* o,
                                                bool transposed) {
    for (int i = 0; i < 3; ++i) {
      const float r0 = transposed ? r[i] : r[3 * i];
      const float r1 = transposed ? r[3 + i] : r[3 * i + 1];
      const float r2 = transposed ? r[6 + i] : r[3 * i + 2];
      o[i] = __fadd_rn(__fadd_rn(__fmul_rn(r0, v[0]), __fmul_rn(r1, v[1])), __fmul_rn(r2, v[2]));
    }
  }

  static __device__ __forceinline__ void add3(const float* a, const float* b, float* o) {
    for (int i = 0; i < 3; ++i) o[i] = __fadd_rn(a[i], b[i]);
  }

  // joint torques tau of the motion (q, qd, qdd) at the links (R, P), gravity g (0 or 9.81):
  // panda_inverse_dynamics_unrolled. pc points at dt.
  static __device__ void rne(const float* R, const float* P, const float* __restrict__ pc,
                             const float* qd, const float* qdd, float g, float* tau) {
    const float* mass = pc + 36;
    const float* com = pc + 43;
    const float* inr = pc + 64;
    float omega[3] = {0.f, 0.f, 0.f}, omegad[3] = {0.f, 0.f, 0.f}, vd[3] = {0.f, 0.f, g};
    float F[7][3], N[7][3];
    float t1[3], t2[3], t3[3], v[3];
    for (int i = 0; i < 7; ++i) {
      const float* r = R + 9 * i;
      const float* p = P + 3 * i;
      float c[3], in[9];
      for (int j = 0; j < 3; ++j) c[j] = __ldg(com + 3 * i + j);
      for (int j = 0; j < 9; ++j) in[j] = __ldg(inr + 9 * i + j);
      cross(omegad, p, t1);
      cross(omega, p, t2);
      cross(omega, t2, t3);
      add3(vd, t1, v);
      add3(v, t3, v);
      matvec(r, v, vd, true);
      float omega_r[3];
      matvec(r, omega, omega_r, true);
      const float qdz[3] = {0.f, 0.f, qd[i]};
      matvec(r, omegad, t1, true);
      cross(omega_r, qdz, t2);
      add3(t1, t2, t1);
      omegad[0] = __fadd_rn(t1[0], 0.f);
      omegad[1] = __fadd_rn(t1[1], 0.f);
      omegad[2] = __fadd_rn(t1[2], qdd[i]);
      add3(omega_r, qdz, omega);
      float vdc[3];
      cross(omegad, c, t1);
      add3(vd, t1, vdc);
      cross(omega, c, t2);
      cross(omega, t2, t3);
      add3(vdc, t3, vdc);
      const float mi = __ldg(mass + i);
      for (int j = 0; j < 3; ++j) F[i][j] = __fmul_rn(mi, vdc[j]);
      matvec(in, omegad, t1, false);
      matvec(in, omega, t2, false);
      cross(omega, t2, t3);
      add3(t1, t3, N[i]);
    }
    float f_next[3] = {0.f, 0.f, 0.f}, n_next[3] = {0.f, 0.f, 0.f};
    for (int i = 6; i >= 0; --i) {
      float fc[3] = {0.f, 0.f, 0.f}, nc[3] = {0.f, 0.f, 0.f};
      if (i < 6) {
        matvec(R + 9 * (i + 1), f_next, fc, false);
        matvec(R + 9 * (i + 1), n_next, t1, false);
        cross(P + 3 * (i + 1), fc, t2);
        add3(t1, t2, nc);
      }
      float c[3];
      for (int j = 0; j < 3; ++j) c[j] = __ldg(com + 3 * i + j);
      add3(fc, F[i], f_next);
      add3(N[i], nc, t1);
      cross(c, F[i], t2);
      add3(t1, t2, n_next);
      tau[i] = n_next[2];
    }
  }

  static __device__ __noinline__ void step(const float* x, const float* u,
                                           const float* __restrict__ pc, float* xn) {
    const float dt = __ldg(pc);
    const float* visc = pc + 127;
    const float* qref = pc + 134;
    float q[7], qd[7], zero[7], unit[7], R[63], P[21], bias[7], M[49], col[7];
    for (int i = 0; i < 7; ++i) {
      q[i] = __fadd_rn(x[i], __ldg(qref + i));
      qd[i] = x[7 + i];
      zero[i] = unit[i] = 0.f;
    }
    links(q, pc + 1, R, P);
    rne(R, P, pc, qd, zero, 9.81f, bias);
    for (int j = 0; j < 7; ++j) {  // column j of M: the unit acceleration e_j at rest, no gravity
      unit[j] = 1.f;
      rne(R, P, pc, zero, unit, 0.f, col);
      unit[j] = 0.f;
      for (int i = 0; i < 7; ++i) M[7 * i + j] = col[i];
    }
    float S[49], rhs[7];
    for (int i = 0; i < 7; ++i) {
      for (int j = 0; j < 7; ++j) S[7 * i + j] = __fmul_rn(0.5f, __fadd_rn(M[7 * i + j], M[7 * j + i]));
      rhs[i] = __fsub_rn(__fsub_rn(u[i], bias[i]), __fmul_rn(__ldg(visc + i), qd[i]));
    }
    // the unrolled Cholesky factor L (lower, row-major in M's storage) and the two solves
    float* L = M;
    for (int i = 0; i < 7; ++i)
      for (int j = 0; j <= i; ++j) {
        float acc = S[7 * i + j];
        for (int k = 0; k < j; ++k) acc = __fsub_rn(acc, __fmul_rn(L[7 * i + k], L[7 * j + k]));
        L[7 * i + j] = i == j ? __fsqrt_rn(acc) : __fdiv_rn(acc, L[7 * j + j]);
      }
    float y[7], qdd[7];
    for (int i = 0; i < 7; ++i) {
      float acc = rhs[i];
      for (int k = 0; k < i; ++k) acc = __fsub_rn(acc, __fmul_rn(L[7 * i + k], y[k]));
      y[i] = __fdiv_rn(acc, L[7 * i + i]);
    }
    for (int i = 6; i >= 0; --i) {
      float acc = y[i];
      for (int k = i + 1; k < 7; ++k) acc = __fsub_rn(acc, __fmul_rn(L[7 * k + i], qdd[k]));
      qdd[i] = __fdiv_rn(acc, L[7 * i + i]);
    }
    for (int i = 0; i < 7; ++i) {
      const float v = __fadd_rn(qd[i], __fmul_rn(qdd[i], dt));
      xn[7 + i] = v;
      xn[i] = __fadd_rn(x[i], __fmul_rn(v, dt));
    }
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

// The panda arm's context (mpc_via_diffusion_model_tpu_torch/dynamics/arm.py, PandaContext,
// the JAX package's make_panda_context) from its shifted 14-state: DC = 20 entries
// (q | qd | ee position | ee velocity), q = x[:7] + q_ref. pc holds q_ref (7), then the FK's
// link table (7 x a, cos alpha, sin alpha, -d sin alpha, d cos alpha) and the flange's d. Each
// thread computes its entry: an entry of q or qd alone; an entry of the end effector's position
// or velocity through the whole FK chain, carried in forward mode with its derivative along
// qd, which is J(q) qd (the torch version takes the same directional derivative by
// torch.func.jvp): per link [R | P] <- [R R_i | R P_i + P] and [dR | dP] <- [dR R_i + R dR_i |
// dR P_i + dP], with dR_i = (dR_i / dq_i) qd_i; then the flange's offset along R's third
// column. Six threads run the chain, the rest of the kernel waits at its next barrier.
struct PandaContext {
  static constexpr int DC = 20;
  static constexpr int N_CONSTS = 7 + 35 + 1;

  static __device__ float map(const float* x, const float* __restrict__ pc, int i) {
    if (i < 7) return __fadd_rn(x[i], __ldg(pc + i));
    if (i < 14) return x[i];
    const float* lk = pc + 7;
    float R[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f}, P[3] = {0.f, 0.f, 0.f};
    float dR[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, dP[3] = {0.f, 0.f, 0.f};
    for (int l = 0; l < 7; ++l) {
      const float a = __ldg(lk + 5 * l), ca = __ldg(lk + 5 * l + 1), sa = __ldg(lk + 5 * l + 2);
      const float p1 = __ldg(lk + 5 * l + 3), p2 = __ldg(lk + 5 * l + 4);
      const float q = __fadd_rn(x[l], __ldg(pc + l)), w = x[7 + l];
      const float cq = cosf(q), sq = sinf(q);
      const float ri[9] = {cq, -sq, 0.f, __fmul_rn(sq, ca), __fmul_rn(cq, ca), -sa,
                           __fmul_rn(sq, sa), __fmul_rn(cq, sa), ca};
      const float dri[9] = {__fmul_rn(-sq, w), __fmul_rn(-cq, w), 0.f,
                            __fmul_rn(__fmul_rn(cq, ca), w), __fmul_rn(__fmul_rn(-sq, ca), w), 0.f,
                            __fmul_rn(__fmul_rn(cq, sa), w), __fmul_rn(__fmul_rn(-sq, sa), w), 0.f};
      const float pi[3] = {a, p1, p2};
      float Rn[9], dRn[9], Pn[3], dPn[3];
      for (int r = 0; r < 3; ++r) {
        for (int c = 0; c < 3; ++c) {
          float s = 0.f, ds = 0.f;
          for (int k = 0; k < 3; ++k) {
            s = __fadd_rn(s, __fmul_rn(R[3 * r + k], ri[3 * k + c]));
            ds = __fadd_rn(ds, __fadd_rn(__fmul_rn(dR[3 * r + k], ri[3 * k + c]),
                                         __fmul_rn(R[3 * r + k], dri[3 * k + c])));
          }
          Rn[3 * r + c] = s;
          dRn[3 * r + c] = ds;
        }
        float s = P[r], ds = dP[r];
        for (int k = 0; k < 3; ++k) {
          s = __fadd_rn(s, __fmul_rn(R[3 * r + k], pi[k]));
          ds = __fadd_rn(ds, __fmul_rn(dR[3 * r + k], pi[k]));
        }
        Pn[r] = s;
        dPn[r] = ds;
      }
      for (int k = 0; k < 9; ++k) { R[k] = Rn[k]; dR[k] = dRn[k]; }
      for (int k = 0; k < 3; ++k) { P[k] = Pn[k]; dP[k] = dPn[k]; }
    }
    const float fd = __ldg(pc + 42);
    const int r = (i - 14) % 3;
    return i < 17 ? __fadd_rn(P[r], __fmul_rn(R[3 * r + 2], fd))
                  : __fadd_rn(dP[r], __fmul_rn(dR[3 * r + 2], fd));
  }
};
