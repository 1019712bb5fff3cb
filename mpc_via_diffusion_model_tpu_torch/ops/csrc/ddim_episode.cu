// The DDIM episode kernel of ddim_episode.cuh for the 5-state swing-up cart-pole
// (plants.cuh, CartpoleSwingup), with the selection QuadraticCost and staged noise.
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_episode.py::
// make_fused_ddim_episode (pallas_call at fused_episode.py:392), the fast path of
// scripts/bench_deep_students.py, and its jax.vmap fleet of scripts/bench_throughput.py;
// ddim_episode.cuh says how. Entries: ddim_episode (fp32 weights) and ddim_episode_bf16 (bf16
// weights, the JAX builder's weights_dtype=jnp.bfloat16).

#include "ddim_episode.cuh"

extern "C" {

// <entry>_launch: a fleet of n_episodes episodes, one cluster each, on `stream`, returning the
// CUDA error code (0 = launched); <entry>_max_active_clusters: cudaOccupancyMaxActiveClusters
// for one episode's cluster at smem_bytes of dynamic shared memory per CTA, into *n_clusters.
DDIM_EPISODE_ENTRY(ddim_episode, false)
DDIM_EPISODE_BF16_ENTRY(ddim_episode_bf16, false)

}  // extern "C"
