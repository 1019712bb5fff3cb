// The temporal U-Net body's shared-memory layout, meta table and block-wide helpers: the
// halo layout (row_off, zero_halo), the meta table's indices (load_meta), Mish, and the
// launchers' once-per-size shared-memory attribute (reserve_smem). The U-Net body itself is
// unet_body_cluster.cuh's, split over a thread-block cluster of 8 CTAs in every kernel that
// runs it: cfg_chain.cu, cfg_episode.cu (two row-sets), fused_unet.cu, ddim_chain.cu and
// ddim_episode.cu (one). It keeps this file's layout, plan and meta table. fused_conv.cu, the
// conv block on no model path, uses this file's HALO, M_LEN, Mish and reserve_smem only.
//
// Port of the pieces of the U-Net body that mpc_via_diffusion_model_tpu/ops/fused_unet.py::
// build_unet_ops traces into every Pallas kernel of the JAX package.
//
// Activations live in shared memory as (NB, h + 2*HALO, c) with HALO zero rows above and
// below each row-set, so the 'same' convs need no edge masks.
//
// The meta table (ops/unet_pack.py) holds the architecture, the weight offsets and the
// shared-memory plans; the indices below mirror that file, and every library that includes
// this header reports M_LEN so that the wrapper can check the two agree.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 512          // threads per block
#define HALO 2          // zero rows above and below each activation
#define MAX_LEVELS 4
#define MAX_RES (4 * MAX_LEVELS)
#define RES_STRIDE 13

// meta layout (ops/unet_pack.py)
#define M_H 0
#define M_D 1
#define M_NLEV 2
#define M_NRES 3
#define M_MAXC 4
#define M_BUF 5
#define M_XS 6
#define M_EPS 7
#define M_STATS 8
#define M_SMEM 9
#define M_DIMS 10
#define M_SKIP (M_DIMS + MAX_LEVELS + 1)
#define M_DOWN (M_SKIP + MAX_LEVELS)
#define M_UP (M_DOWN + 2 * MAX_LEVELS)
#define M_FIN (M_UP + 2 * MAX_LEVELS)
#define M_F1 (M_FIN + 5)
#define M_RES (M_F1 + 2)
// conditioning widths, FiLM Dense weights and the episode kernel's shared-memory plan
#define M_COND (M_RES + MAX_RES * RES_STRIDE)  // cond_dim = time_emb_dim + context_dim (+ 1)
#define M_TEMB (M_COND + 1)                    // time_emb_dim
#define M_CTX (M_COND + 2)                     // context_dim
#define M_FW (M_COND + 3)                      // FiLM kernels (n_res, cond_dim, max_c)
#define M_FB (M_COND + 4)                      // FiLM biases (n_res, max_c)
#define M_EP_FILM (M_COND + 5)                 // shared: this step's FiLM (n_res, 2 or 1, max_c)
#define M_EP_MC (M_COND + 6)                   // shared: mish(c_emb) of the groups (2 or 1, cond_dim)
#define M_EP_MISC (M_COND + 7)                 // shared: state, context, first control, choice
#define M_EP_SMEM (M_COND + 8)                 // shared: the episode kernel's meta copy
#define M_LEN (M_COND + 9)
#define R_CIN 0
#define R_COUT 1
#define R_GROUPS 2
#define R_W1 3
#define R_B1 4
#define R_G1 5
#define R_BE1 6
#define R_W2 7
#define R_B2 8
#define R_G2 9
#define R_BE2 10
#define R_WR 11
#define R_BR 12

// offset of row t (may be a halo row, -HALO <= t < h + HALO) of row-set b
static __device__ __forceinline__ int row_off(int b, int h, int t, int c) {
  return (b * (h + 2 * HALO) + HALO + t) * c;
}

static __device__ __forceinline__ float mish_f(float x) {
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // stable softplus
  return x * tanhf(sp);
}

template <int NB>
static __device__ void zero_halo(float* buf, int h, int c) {
  const int n = NB * 2 * HALO * c;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int ch = i % c, q = i / c;
    const int b = q / (2 * HALO), s = q % (2 * HALO);
    const int t = s < HALO ? s - HALO : h + s - HALO;
    buf[row_off(b, h, t, c) + ch] = 0.f;
  }
}

// Raises `kernel`'s dynamic shared-memory limit on the current device to smem_bytes where a
// launch needs more than the 48 KB it may take without asking, once per kernel, device and
// size: set[device] holds the largest limit set so far (devices past MAX_DEVICES ask every
// time). Host code; each launcher keeps one `set` per kernel.
#define MAX_DEVICES 64
template <typename Kernel>
static cudaError_t reserve_smem(Kernel kernel, int smem_bytes, int* set) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && set[dev] >= smem_bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) set[dev] = smem_bytes;
  return e;
}

// Copies the meta table into shared memory at word offset `at` and returns it.
static __device__ int* load_meta(float* smem, const int* __restrict__ meta, int at) {
  int* m = reinterpret_cast<int*>(smem + at);
  for (int i = threadIdx.x; i < M_LEN; i += NT) m[i] = __ldg(meta + i);
  __syncthreads();
  return m;
}
