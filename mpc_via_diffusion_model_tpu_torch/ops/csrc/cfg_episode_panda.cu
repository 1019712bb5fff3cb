// The CFG episode kernel of cfg_episode.cu for the 7-DoF Franka Panda arm's CFG teacher
// (artifacts/flagship_panda_rbd/ema_params.pkl): the arm (plants.cuh, PandaRbd: DX = 14, DU = 7,
// the recursive Newton-Euler bias and mass matrix and the unrolled Cholesky solve of
// dynamics/arm.py::panda_rbd_unrolled, its tables read from the consts table after dt), its
// 20-dim context (plants.cuh, PandaContext: q, qd and the end effector's position and velocity
// through the FK chain, its q_ref and FK table after the plant's), best-of-K candidates scored
// by the selection QuadraticCost, fp32 weights, on the plan in turns.
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_episode.py::
// make_fused_cfg_episode (pallas_call at fused_episode.py:653) traced with
// dynamics/arm.py::panda_rbd_unrolled and make_panda_context: the whole-episode path of
// scripts/bench_highdim.py (--panda-episode-kernel), which runs it with inkernel_noise.
//
// Its two entries: cfg_episode_panda reads staged noise (n_steps, n_total + 1, K, H, D);
// cfg_episode_panda_draw takes the episode's (2,) int32 seed and draws every x_T and every
// injected normal in every CTA (cfg_episode.cu's DRAW, philox.cuh), so that its replan loop
// reads no noise table.
//
// Shared memory. At the teacher's horizon 128 with 7 channels and widths 32/64/128 the
// two-row-set plan of the other CFG entries needs 321,360 B per CTA at K = 1, more than the
// 232,448 B a block may take; the plan in turns (ops/unet_pack.py, metas["turns"]: one
// row-set's activations and skips, eps, FiLM and mish(c_emb) for the two groups) needs 174,928 B
// at K = 1, 185,680 B at K = 4, and fits every K up to 17.
//
// What bounds it on this card. One U-Net pass over one row-set is 73.0 MFLOP of conv FMAs
// against 4.06 MB of weights: an 80-replan episode at K = 1 is 80 x 30 x 2 passes, 350 GFLOP,
// 5.2 ms at the card's fp32 rate. But the replans, the chain's steps, the two passes of a step
// and a pass's layers each need the one before, so the body runs at what one cluster of 8 SMs
// does; and the arm's step is one thread's serial work (plants.cuh): once per replan at K = 1,
// and at K > 1 sel_h steps per candidate on K threads, one candidate each, before the choice.
//
// Its own library and entries, so that every other entry's machine code is left as it was.

#define EPISODE_PLANT PandaRbd
#define EPISODE_CONDITION PandaContext
#define EPISODE_PLANT_ENTRIES
#include "cfg_episode.cu"

// Each entry's C interface besides <entry>_launch.
#define CFG_PANDA_QUERIES(ENTRY, DRAW_)                                                       \
  int ENTRY##_max_active_clusters(int smem_bytes, int* n_clusters) {                          \
    return max_active_clusters<float, true, DRAW_>(smem_bytes, n_clusters);                   \
  }                                                                                           \
  int ENTRY##_cluster_size(void) { return CLUSTER; }                                          \
  const char* ENTRY##_error_string(int code) {                                                \
    return cudaGetErrorString((cudaError_t)code);                                             \
  }                                                                                           \
  int ENTRY##_meta_len(void) { return M_LEN; }                                                \
  int ENTRY##_consts_len(void) { return C_LEN; }                                              \
  int ENTRY##_plant_dims(void) { return DX * 100 + DU; }                                      \
  int ENTRY##_condition_dims(void) { return DC; }

extern "C" {

// Launches one episode on staged noise, one cluster, on `stream`; returns the CUDA error code
// (0 = launched).
int cfg_episode_panda_launch(const float* W, const int* meta, int smem_bytes,
                             const float* t_embs, const float* noise, const float* coefs,
                             const float* consts, const float* x0, float* x_track,
                             float* u_track, float* costs, int* chosen, int n_steps, int n_total,
                             int K, int sel_h, float w, float wp1, int clip, void* stream) {
  return launch<float, true, false>(W, nullptr, meta, smem_bytes, t_embs, noise, coefs, consts,
                                    x0, x_track, u_track, costs, chosen, n_steps, n_total, K,
                                    sel_h, w, wp1, clip, stream);
}

// The same drawing its noise in the kernel: seed is the episode's (2,) int32 seed.
int cfg_episode_panda_draw_launch(const float* W, const int* meta, int smem_bytes,
                                  const float* t_embs, const int* seed, const float* coefs,
                                  const float* consts, const float* x0, float* x_track,
                                  float* u_track, float* costs, int* chosen, int n_steps,
                                  int n_total, int K, int sel_h, float w, float wp1, int clip,
                                  void* stream) {
  return launch<float, true, true>(W, nullptr, meta, smem_bytes, t_embs, seed, coefs, consts, x0,
                                   x_track, u_track, costs, chosen, n_steps, n_total, K, sel_h, w,
                                   wp1, clip, stream);
}

// <entry>_max_active_clusters: cudaOccupancyMaxActiveClusters for one episode's cluster at
// smem_bytes of dynamic shared memory per CTA, into *n_clusters; returns the CUDA error code
// (0 = answered).
CFG_PANDA_QUERIES(cfg_episode_panda, false)
CFG_PANDA_QUERIES(cfg_episode_panda_draw, true)

}  // extern "C"
