// The DDIM episode kernel of ddim_episode.cuh for the 7-DoF Franka Panda arm (plants.cuh,
// PandaRbd: DX = 14, DU = 7, the recursive Newton-Euler bias and mass matrix and the unrolled
// Cholesky solve of dynamics/arm.py::panda_rbd_unrolled, its tables read from the consts table
// after dt), conditioned on the arm's 20-dim context (plants.cuh, PandaContext: q, qd and the
// end effector's position and velocity through the FK chain, its q_ref and FK table after the
// plant's), scoring best-of-K candidates by the selection QuadraticCost, staged noise. Entries:
// ddim_episode_panda (fp32 weights) and ddim_episode_panda_bf16 (bf16 weights, the JAX builder's
// weights_dtype=jnp.bfloat16).
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_episode.py::
// make_fused_ddim_episode (pallas_call at fused_episode.py:392) traced with
// dynamics/arm.py::panda_rbd_unrolled and make_panda_context: the whole-episode path of
// scripts/bench_panda_student.py (--whole-episode). At the panda student's horizon 128 with 7
// channels and widths 32/64/128, a rank's share of every conv is 512 outputs at each level (128
// x 32 / 8, 64 x 64 / 8, 32 x 128 / 8), twice the flagship's; the body's plan on one row-set
// (unet_pack.py) is 154,764 B per CTA before the episode's regions, 164,992 B at K = 1 and
// 175,744 B at K = 4, under the 232,448 B a block may take (the two-row-set plan would need
// 321,360 B at K = 1).
//
// What bounds it on this card. One U-Net pass over one row-set is 73.0 MFLOP of conv FMAs
// against 4.06 MB of weights: an 80-replan episode on the grid [23] is 5.8 GFLOP, 87 us at the
// card's fp32 rate. But the replans, the grid's steps and a pass's layers each need the one
// before, so the body runs at what one cluster of 8 SMs does; and the arm's step is one
// thread's serial work (plants.cuh): once per replan at K = 1, and at K > 1 sel_h steps per
// candidate on K threads, one candidate each, before the choice.
//
// Its own library and entry, so that the other entries' machine code is left as it was.

#define EPISODE_PLANT PandaRbd
#define EPISODE_CONDITION PandaContext
#include "ddim_episode.cuh"

extern "C" {

// Launches one episode, one cluster, on `stream`; returns the CUDA error code (0 = launched).
int ddim_episode_panda_launch(const float* W, const int* meta, int smem_bytes,
                              const float* t_embs, const float* noise, const float* coefs,
                              const float* consts, const float* x0, float* x_track, float* u_track,
                              float* costs, int* chosen, int n_steps, int n_total, int K,
                              int sel_h, int clip, void* stream) {
  return launch<float, false>(W, nullptr, meta, smem_bytes, t_embs, noise, coefs, consts, x0,
                              x_track, u_track, costs, chosen, n_steps, n_total, K, sel_h, clip,
                              stream);
}

// The same with bf16 conv kernels: Wh is the bf16 copy of W (same element offsets).
int ddim_episode_panda_bf16_launch(const float* W, const __nv_bfloat16* Wh, const int* meta,
                                   int smem_bytes, const float* t_embs, const float* noise,
                                   const float* coefs, const float* consts, const float* x0,
                                   float* x_track, float* u_track, float* costs, int* chosen,
                                   int n_steps, int n_total, int K, int sel_h, int clip,
                                   void* stream) {
  return launch<__nv_bfloat16, false>(W, Wh, meta, smem_bytes, t_embs, noise, coefs, consts, x0,
                                      x_track, u_track, costs, chosen, n_steps, n_total, K,
                                      sel_h, clip, stream);
}

// <entry>_max_active_clusters: cudaOccupancyMaxActiveClusters for one episode's cluster at
// smem_bytes of dynamic shared memory per CTA, into *n_clusters; returns the CUDA error code
// (0 = answered).
DDIM_EPISODE_QUERIES(ddim_episode_panda, float, false)
DDIM_EPISODE_QUERIES(ddim_episode_panda_bf16, __nv_bfloat16, false)

int ddim_episode_panda_condition_dims(void) { return DC; }
int ddim_episode_panda_bf16_condition_dims(void) { return DC; }

}  // extern "C"
