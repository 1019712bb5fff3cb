// The CFG episode kernel of cfg_episode.cu for the scene-conditioned quadrotor student
// (plants.cuh: Quadrotor, DX = 12, DU = 4, m and the inertia read from the consts table after
// dt), its context the state followed by the scene's 12 features (ConcatFeatures<12, 12>, DC =
// 24, the features read from the table after the plant's constants), scoring best-of-K
// candidates by the quadrotor task's safety-first selection cost against the scene's three
// spheres (SafetyFirstScorer<12, 4, 3>, its constants last in the table), with fp32 weights and
// staged noise.
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_episode.py::
// make_fused_cfg_episode (pallas_call at fused_episode.py:653) traced with the quadrotor
// plant, scripts/quadrotor_task.py::make_select_cost(centers, radii) of one scene and
// state_to_condition = x -> [x, scene_features]: the serving path of
// scripts/bench_scene_student.py. The JAX kernel hoists the scene's spheres and features into
// its input list, so that one compiled kernel serves every scene (fused_episode.py:442-446);
// here both are data in the consts table, and one build serves every scene. At the student's
// horizon 48 the U-Net body's levels hold 48, 24 and 12 rows per row-set; at K = 16 the staged
// noise of a 60-replan episode is 60 x 31 x 16 x 48 x 4 floats (5.7 MB), read once.
//
// Its own library and entries (cfg_episode_quadrotor_*), so that every other entry's machine
// code is left as it was.

#define EPISODE_PLANT Quadrotor
#define EPISODE_SCORER SafetyFirstScorer<12, 4, 3>
#define EPISODE_CONDITION ConcatFeatures<12, 12>
#define EPISODE_PLANT_ENTRIES
#include "cfg_episode.cu"

extern "C" {

// Launches a fleet of n_episodes episodes, one cluster each, on `stream`; returns the CUDA
// error code (0 = launched). Every episode of a fleet sees the scene in consts.
int cfg_episode_quadrotor_launch(const float* W, const int* meta, int smem_bytes,
                                 const float* t_embs, const float* noise, const float* coefs,
                                 const float* consts, const float* x0, float* x_track,
                                 float* u_track, float* costs, int* chosen, int n_steps,
                                 int n_total, int K, int sel_h, float w, float wp1, int clip,
                                 int n_episodes, void* stream) {
  return launch<float>(W, nullptr, meta, smem_bytes, t_embs, noise, coefs, consts, x0, x_track,
                       u_track, costs, chosen, n_steps, n_total, K, sel_h, w, wp1, clip,
                       n_episodes, stream);
}

// cudaOccupancyMaxActiveClusters for one episode's cluster at smem_bytes of dynamic shared
// memory per CTA, into *n_clusters; returns the CUDA error code (0 = answered).
int cfg_episode_quadrotor_max_active_clusters(int smem_bytes, int* n_clusters) {
  return max_active_clusters<float>(smem_bytes, n_clusters);
}

int cfg_episode_quadrotor_cluster_size(void) { return CLUSTER; }

const char* cfg_episode_quadrotor_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int cfg_episode_quadrotor_meta_len(void) { return M_LEN; }

int cfg_episode_quadrotor_consts_len(void) { return C_LEN; }

int cfg_episode_quadrotor_plant_dims(void) { return DX * 100 + DU; }

// The width of the context the kernel's condition map makes (the model's context_dim).
int cfg_episode_quadrotor_condition_dims(void) { return DC; }

}  // extern "C"
