"""PyTorch/CUDA port of the diffusion-MPC engine, for one NVIDIA H100.

The JAX package ``mpc_via_diffusion_model_tpu`` beside this one is the
reference each module here is tested against. This package imports
``torch`` and ``numpy`` only: never ``jax``, ``flax`` or the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper runs its plain PyTorch version.
"""
