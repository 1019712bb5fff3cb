from .ilqr import (ILQRConfig, ILQRSolution, ilqr_backward, ilqr_forward, ilqr_solve,
                   ilqr_solve_batched, pd_solve)
from .lqr import LQRSolution, lqr_gains, lqr_solve, lqr_solve_batched

__all__ = ["ILQRConfig", "ILQRSolution", "LQRSolution", "ilqr_backward", "ilqr_forward",
           "ilqr_solve", "ilqr_solve_batched", "lqr_gains", "lqr_solve", "lqr_solve_batched",
           "pd_solve"]
