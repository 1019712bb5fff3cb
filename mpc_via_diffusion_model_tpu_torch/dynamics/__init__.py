from .base import Plant, QuadraticCost, reference_mpc_cost, rollout, rollout_with_cost
from .cartpole import (cartpole_virtual_collect_cost, cartpole_virtual_cost,
                       cartpole_virtual_swingup, theta_to_red_theta)

__all__ = ["Plant", "QuadraticCost", "cartpole_virtual_collect_cost", "cartpole_virtual_cost",
           "cartpole_virtual_swingup", "reference_mpc_cost", "rollout", "rollout_with_cost",
           "theta_to_red_theta"]
