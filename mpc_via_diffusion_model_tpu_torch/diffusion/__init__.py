from .gaussian_diffusion import GaussianDiffusion

__all__ = ["GaussianDiffusion"]
