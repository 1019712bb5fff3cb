// The CFG chain kernel of cfg_chain.cu on the plan in turns (TURNS): each step's conditional
// and unconditional passes one after the other on one row-set, where the two-row-set plan does
// not fit one block (the panda arm's horizon 128: 304,780 B per CTA on two row-sets, 158,348 B
// in turns). Replaces, with cfg_chain.cu, the TPU kernel
// mpc_via_diffusion_model_tpu/ops/fused_denoise.py::make_fused_cfg_chain (pallas_call at
// fused_denoise.py:151); cfg_chain.cu says what bounds it and why the passes in turn compute
// the doubled batch's arithmetic.
//
// Its own library and entries (cfg_chain_turns, cfg_chain_turns_bf16), so that it builds in
// parallel with cfg_chain.cu's and leaves their machine code as it was.

#define CFG_CHAIN_TURNS_ENTRIES
#include "cfg_chain.cu"

extern "C" {

// Launches the chain in turns, one cluster per sample, on `stream`, on the in-turn plan's meta
// table; returns the CUDA error code (0 = launched).
int cfg_chain_turns_launch(const float* W, const int* meta, int smem_bytes, const float* films,
                           const float* noise, const float* coefs, float* out, int n_total,
                           int n_samples, float w, float wp1, int clip, void* stream) {
  return launch<float, true>(W, nullptr, meta, smem_bytes, films, noise, coefs, out, n_total,
                             n_samples, w, wp1, clip, stream);
}

// The same with bf16 conv kernels: Wh is the bf16 copy of W (same element offsets).
int cfg_chain_turns_bf16_launch(const float* W, const __nv_bfloat16* Wh, const int* meta,
                                int smem_bytes, const float* films, const float* noise,
                                const float* coefs, float* out, int n_total, int n_samples,
                                float w, float wp1, int clip, void* stream) {
  return launch<__nv_bfloat16, true>(W, Wh, meta, smem_bytes, films, noise, coefs, out,
                                     n_total, n_samples, w, wp1, clip, stream);
}

// <entry>_max_active_clusters: cudaOccupancyMaxActiveClusters for one sample's cluster at
// smem_bytes of dynamic shared memory per CTA, into *n_clusters; returns the CUDA error code
// (0 = answered).
CFG_CHAIN_QUERIES(cfg_chain_turns, float, true)
CFG_CHAIN_QUERIES(cfg_chain_turns_bf16, __nv_bfloat16, true)

}  // extern "C"
