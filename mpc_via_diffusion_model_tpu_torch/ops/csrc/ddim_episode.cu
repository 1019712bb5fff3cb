// The DDIM episode kernel of ddim_episode.cuh for the 5-state swing-up cart-pole
// (plants.cuh, CartpoleSwingup), with the selection QuadraticCost and staged noise.
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_episode.py::
// make_fused_ddim_episode (pallas_call at fused_episode.py:392), the fast path of
// scripts/bench_deep_students.py; ddim_episode.cuh says how. Entries: ddim_episode (fp32
// weights) and ddim_episode_bf16 (bf16 weights, the JAX builder's weights_dtype=jnp.bfloat16).

#include "ddim_episode.cuh"

extern "C" {

// Launches one episode, one cluster, on `stream`; returns the CUDA error code (0 = launched).
int ddim_episode_launch(const float* W, const int* meta, int smem_bytes, const float* t_embs,
                        const float* noise, const float* coefs, const float* consts,
                        const float* x0, float* x_track, float* u_track, float* costs,
                        int* chosen, int n_steps, int n_total, int K, int sel_h, int clip,
                        void* stream) {
  return launch<float, false>(W, nullptr, meta, smem_bytes, t_embs, noise, coefs, consts, x0,
                              x_track, u_track, costs, chosen, n_steps, n_total, K, sel_h, clip,
                              stream);
}

// The same with bf16 conv kernels: Wh is the bf16 copy of W (same element offsets).
int ddim_episode_bf16_launch(const float* W, const __nv_bfloat16* Wh, const int* meta,
                             int smem_bytes, const float* t_embs, const float* noise,
                             const float* coefs, const float* consts, const float* x0,
                             float* x_track, float* u_track, float* costs, int* chosen,
                             int n_steps, int n_total, int K, int sel_h, int clip, void* stream) {
  return launch<__nv_bfloat16, false>(W, Wh, meta, smem_bytes, t_embs, noise, coefs, consts, x0,
                                      x_track, u_track, costs, chosen, n_steps, n_total, K,
                                      sel_h, clip, stream);
}

// <entry>_max_active_clusters: cudaOccupancyMaxActiveClusters for one episode's cluster at
// smem_bytes of dynamic shared memory per CTA, into *n_clusters; returns the CUDA error code
// (0 = answered).
DDIM_EPISODE_QUERIES(ddim_episode, float, false)
DDIM_EPISODE_QUERIES(ddim_episode_bf16, __nv_bfloat16, false)

}  // extern "C"
