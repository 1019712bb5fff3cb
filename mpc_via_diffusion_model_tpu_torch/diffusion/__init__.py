from .distillation import (ddim_affine_coefs, ddim_time_grid, distill_loss, distill_pair_tables,
                           halve_times, make_distill_step, make_student_ddim_sampler)
from .gaussian_diffusion import GaussianDiffusion, ddim_times

__all__ = ["GaussianDiffusion", "ddim_affine_coefs", "ddim_times", "ddim_time_grid", "distill_loss",
           "distill_pair_tables", "halve_times", "make_distill_step", "make_student_ddim_sampler"]
