// The bf16 entries of the quadrotor's DDIM episode: the __nv_bfloat16 instantiations of
// ddim_episode.cuh's kernel for the 12-state quadrotor and its safety-first scorer, as
// ddim_episode_quadrotor.cu compiles the float ones, with staged noise
// (ddim_episode_quadrotor_bf16) or the in-kernel draw (ddim_episode_quadrotor_draw_bf16).
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_episode.py::
// make_fused_ddim_episode (pallas_call at fused_episode.py:392) traced with the quadrotor plant
// and weights_dtype=jnp.bfloat16; ddim_episode.cuh says how the bf16 instantiation reads its
// weights and rounds its operands.
//
// A library of its own, not two more entries of ddim_episode_quadrotor.cu: nvcc compiles every
// source in a process of its own, all at once (ops/_build.py::build_all), and four
// instantiations of the episode kernel in one source made that library the build's longest
// compile (78.9 s against 49.0 s for the longest of the rest, on an H100 machine's host).

#define EPISODE_PLANT Quadrotor
#define EPISODE_SCORER SafetyFirstScorer<12, 4, 3>
#include "ddim_episode.cuh"

extern "C" {

// <entry>_launch: a fleet of n_episodes episodes, one cluster each, on `stream`, returning the
// CUDA error code (0 = launched); the _draw entry takes the (n_episodes, 2) seed words in place
// of the staged noise. <entry>_max_active_clusters: cudaOccupancyMaxActiveClusters for one
// episode's cluster at smem_bytes of dynamic shared memory per CTA, into *n_clusters.
DDIM_EPISODE_BF16_ENTRY(ddim_episode_quadrotor_bf16, false)
DDIM_EPISODE_BF16_ENTRY(ddim_episode_quadrotor_draw_bf16, true)

}  // extern "C"
