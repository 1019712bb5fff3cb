from .base import Plant, QuadraticCost
from .cartpole import cartpole_virtual_cost, cartpole_virtual_swingup, theta_to_red_theta

__all__ = ["Plant", "QuadraticCost", "cartpole_virtual_cost", "cartpole_virtual_swingup",
           "theta_to_red_theta"]
