from .distillation import (ddim_affine_coefs, ddim_time_grid, halve_times,
                           make_student_ddim_sampler)
from .gaussian_diffusion import GaussianDiffusion

__all__ = ["GaussianDiffusion", "ddim_affine_coefs", "ddim_time_grid", "halve_times",
           "make_student_ddim_sampler"]
