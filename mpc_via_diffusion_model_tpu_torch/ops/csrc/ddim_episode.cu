// The DDIM episode kernel of ddim_episode.cuh for the 5-state swing-up cart-pole
// (plants.cuh, CartpoleSwingup), with the selection QuadraticCost and staged noise.
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_episode.py::
// make_fused_ddim_episode (pallas_call at fused_episode.py:392), the fast path of
// scripts/bench_deep_students.py; ddim_episode.cuh says how.

#include "ddim_episode.cuh"

extern "C" {

// Launches one episode, one cluster, on `stream`; returns the CUDA error code (0 = launched).
int ddim_episode_launch(const float* W, const int* meta, int smem_bytes, const float* t_embs,
                        const float* noise, const float* coefs, const float* consts,
                        const float* x0, float* x_track, float* u_track, float* costs,
                        int* chosen, int n_steps, int n_total, int K, int sel_h, void* stream) {
  return launch<false>(W, meta, smem_bytes, t_embs, noise, coefs, consts, x0, x_track, u_track,
                       costs, chosen, n_steps, n_total, K, sel_h, stream);
}

// cudaOccupancyMaxActiveClusters for one episode's cluster at smem_bytes of dynamic shared
// memory per CTA, into *n_clusters; returns the CUDA error code (0 = answered).
int ddim_episode_max_active_clusters(int smem_bytes, int* n_clusters) {
  return max_active_clusters<false>(smem_bytes, n_clusters);
}

int ddim_episode_cluster_size(void) { return CLUSTER; }

const char* ddim_episode_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ddim_episode_meta_len(void) { return M_LEN; }

int ddim_episode_consts_len(void) { return C_LEN; }

int ddim_episode_plant_dims(void) { return DX * 100 + DU; }

}  // extern "C"
