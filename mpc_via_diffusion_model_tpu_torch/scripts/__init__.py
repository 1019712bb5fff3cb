"""Entry points of the port, each run as ``python -m mpc_via_diffusion_model_tpu_torch.scripts.<name>``."""
