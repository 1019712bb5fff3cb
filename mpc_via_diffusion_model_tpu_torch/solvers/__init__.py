from .lqr import LQRSolution, lqr_gains, lqr_solve, lqr_solve_batched

__all__ = ["LQRSolution", "lqr_gains", "lqr_solve", "lqr_solve_batched"]
