// The episode kernel's in-kernel noise: Philox4x32-10 (Salmon et al., "Parallel random
// numbers: as easy as 1, 2, 3", SC 2011), written out here (no cuRAND), and the JAX package's
// Box-Muller map from two 32-bit words to one normal (mpc_via_diffusion_model_tpu/ops/
// fused_episode.py::_bits_to_normal, :65). The plain twin is ops/philox.py.
//
// A counter-based generator has no state: the normal at (replan s, candidate k, row t,
// channel d) of an episode seeded (k0, k1) is bits_to_normal(w0, w1) of the words
// philox4x32_10((s, k, t, d), (k0, k1)). Every CTA of a cluster therefore draws the same
// values with no exchange, as the cluster's replicated work outside the U-Net body needs
// (a stateful per-thread generator would make the ranks disagree).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PHILOX_M0 0xD2511F53u
#define PHILOX_M1 0xCD9E8D57u
#define PHILOX_W0 0x9E3779B9u
#define PHILOX_W1 0xBB67AE85u

// Ten rounds; the key is bumped before every round but the first.
static __device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Box-Muller from the top 24 bits of each word, in _bits_to_normal's order:
// u1 = (i1 + 1) / 2^24 in (0, 1], u2 = i2 / 2^24 in [0, 1), sqrt(-2 log u1) cos(2 pi u2).
// logf and cosf are the accurate library functions (no --use_fast_math).
static __device__ __forceinline__ float bits_to_normal(uint32_t b1, uint32_t b2) {
  const float inv24 = 5.9604644775390625e-08f;  // 2^-24
  const float u1 = __fmul_rn(__fadd_rn(__uint2float_rn(b1 >> 8), 1.f), inv24);
  const float u2 = __fmul_rn(__uint2float_rn(b2 >> 8), inv24);
  const float r = __fsqrt_rn(__fmul_rn(-2.f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.28318548202514648f, u2)));  // float32(2 pi)
}

// The episode's normal at (replan s, candidate k, row t, channel d) under the key (k0, k1).
static __device__ __forceinline__ float philox_normal(int s, int k, int t, int d, uint32_t k0,
                                                      uint32_t k1) {
  const uint4 w = philox4x32_10(make_uint4((uint32_t)s, (uint32_t)k, (uint32_t)t, (uint32_t)d),
                                k0, k1);
  return bits_to_normal(w.x, w.y);
}
