// The CFG episode kernel of cfg_episode.cu for the linear cart-pole of the LMPC workload
// (plants.cuh, CartpoleLmpc: DX = 4, A_d and B_d read from the consts table after dt), with
// fp32 weights only.
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_episode.py::
// make_fused_cfg_episode (pallas_call at fused_episode.py:653) traced with cartpole_lmpc,
// whose step the JAX kernel hoists as the kernel inputs a_d and b_d (_kernel_safe_fn). The
// kernel is cfg_episode.cu's, compiled with another plant: the consts offsets follow DX, and
// the table gains the plant's 20 constants. At the LMPC's horizon 8 the three levels of the
// U-Net body hold 8, 4 and 2 rows per row-set, and a conv item (CL_RPT = 8 rows,
// unet_body_cluster.cuh) covers a level's rows of both row-sets, each row read from its own
// row-set's halo layout.
//
// Its own library and entries (cfg_episode_lmpc_*), so that the swing-up entries'
// machine code is left as it was.

#define EPISODE_PLANT CartpoleLmpc
#define EPISODE_PLANT_ENTRIES
#include "cfg_episode.cu"

extern "C" {

// Launches a fleet of n_episodes episodes, one cluster each, on `stream`; returns the CUDA
// error code (0 = launched).
int cfg_episode_lmpc_launch(const float* W, const int* meta, int smem_bytes,
                            const float* t_embs, const float* noise, const float* coefs,
                            const float* consts, const float* x0, float* x_track,
                            float* u_track, float* costs, int* chosen, int n_steps, int n_total,
                            int K, int sel_h, float w, float wp1, int clip, int n_episodes,
                            void* stream) {
  return launch<float>(W, nullptr, meta, smem_bytes, t_embs, noise, coefs, consts, x0, x_track,
                       u_track, costs, chosen, n_steps, n_total, K, sel_h, w, wp1, clip,
                       n_episodes, stream);
}

// cudaOccupancyMaxActiveClusters for one episode's cluster at smem_bytes of dynamic shared
// memory per CTA, into *n_clusters; returns the CUDA error code (0 = answered).
int cfg_episode_lmpc_max_active_clusters(int smem_bytes, int* n_clusters) {
  return max_active_clusters<float>(smem_bytes, n_clusters);
}

int cfg_episode_lmpc_cluster_size(void) { return CLUSTER; }

const char* cfg_episode_lmpc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int cfg_episode_lmpc_meta_len(void) { return M_LEN; }

int cfg_episode_lmpc_consts_len(void) { return C_LEN; }

int cfg_episode_lmpc_plant_dims(void) { return DX * 100 + DU; }

}  // extern "C"
