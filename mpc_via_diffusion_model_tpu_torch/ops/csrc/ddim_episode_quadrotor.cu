// The DDIM episode kernel of ddim_episode.cuh for the 12-state quadrotor (plants.cuh,
// Quadrotor: DX = 12, DU = 4, m and the inertia read from the consts table after dt), scoring
// best-of-K candidates by the quadrotor task's safety-first selection cost (plants.cuh,
// SafetyFirstScorer: the hover quadratic, the control effort and the obstacle hinge against
// three spheres, whose constants follow the plant's in the table), fp32 weights, with staged
// noise (ddim_episode_quadrotor_*) or the in-kernel draw (ddim_episode_quadrotor_draw_*); the bf16
// entries are ddim_episode_quadrotor_bf16.cu's.
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_episode.py::
// make_fused_ddim_episode (pallas_call at fused_episode.py:392) traced with the quadrotor
// plant and scripts/quadrotor_task.py::make_select_cost, with and without inkernel_noise: the
// fast path of scripts/bench_quadrotor_student.py and, under jax.vmap, its --fleet. At the
// student's horizon 48 the U-Net body's levels hold 48, 24 and 12 rows, so the last conv item of
// the 12-row level (CL_RPT = 8 rows, unet_body_cluster.cuh) is half full; at K = 16 the staged
// noise is 600 x 16 x 48 x 4 floats (7.4 MB) for a 600-replan episode, read once per replan.
//
// Its own library and entries, so that the swing-up entries' machine code is left as it was.
// The philox_* entries write Philox words and the episode's normals for the tests of the draw.

#define EPISODE_PLANT Quadrotor
#define EPISODE_SCORER SafetyFirstScorer<12, 4, 3>
#include "ddim_episode.cuh"

// The four Philox4x32-10 words of n (counter, key) pairs: counters (n, 4), keys (n, 2).
__global__ void philox_words_kernel(const uint32_t* __restrict__ counters,
                                    const uint32_t* __restrict__ keys, uint32_t* __restrict__ out,
                                    int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const uint4 c = make_uint4(counters[4 * i], counters[4 * i + 1], counters[4 * i + 2],
                               counters[4 * i + 3]);
    const uint4 w = philox4x32_10(c, keys[2 * i], keys[2 * i + 1]);
    out[4 * i] = w.x;
    out[4 * i + 1] = w.y;
    out[4 * i + 2] = w.z;
    out[4 * i + 3] = w.w;
  }
}

// The in-kernel draw of a whole episode, (n_steps, K, H, D), as the episode kernel draws it.
__global__ void philox_normals_kernel(const int* __restrict__ seed, float* __restrict__ out,
                                      int n_steps, int K, int H, int D) {
  const uint32_t k0 = (uint32_t)__ldg(seed), k1 = (uint32_t)__ldg(seed + 1);
  const long long n = (long long)n_steps * K * H * D;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int d = (int)(i % D), t = (int)((i / D) % H), k = (int)((i / ((long long)D * H)) % K);
    const int s = (int)(i / ((long long)D * H * K));
    out[i] = philox_normal(s, k, t, d, k0, k1);
  }
}

extern "C" {

// <entry>_launch: a fleet of n_episodes episodes, one cluster each, on `stream`, returning the
// CUDA error code (0 = launched); the _draw entries take the (n_episodes, 2) seed words in place
// of the staged noise. <entry>_max_active_clusters: cudaOccupancyMaxActiveClusters for one
// episode's cluster at smem_bytes of dynamic shared memory per CTA, into *n_clusters.
DDIM_EPISODE_ENTRY(ddim_episode_quadrotor, false)
DDIM_EPISODE_ENTRY(ddim_episode_quadrotor_draw, true)

// Philox words of n (counter, key) pairs into out (n, 4), on `stream`.
int ddim_episode_quadrotor_philox_words_launch(const uint32_t* counters, const uint32_t* keys,
                                               uint32_t* out, int n, void* stream) {
  philox_words_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(counters, keys, out, n);
  return (int)cudaGetLastError();
}

// The episode's in-kernel draw (n_steps, K, H, D) for `seed` into out, on `stream`.
int ddim_episode_quadrotor_philox_normals_launch(const int* seed, float* out, int n_steps, int K,
                                                 int H, int D, void* stream) {
  philox_normals_kernel<<<528, 256, 0, (cudaStream_t)stream>>>(seed, out, n_steps, K, H, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
