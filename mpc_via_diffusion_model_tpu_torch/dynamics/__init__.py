from .arm import (PANDA_READY_POSE, PandaContext, make_panda_context, panda_context, panda_cost,
                  panda_ee_velocity, panda_fk, panda_inverse_dynamics,
                  panda_inverse_dynamics_unrolled, panda_link_transforms, panda_mass_matrix,
                  panda_rbd, panda_rbd_unrolled, panda_surrogate)
from .base import Plant, QuadraticCost, reference_mpc_cost, rollout, rollout_with_cost
from .cartpole import (cartpole_lmpc, cartpole_lmpc_cost, cartpole_virtual_collect_cost,
                       cartpole_virtual_cost, cartpole_virtual_stabilized,
                       cartpole_virtual_swingup, theta_to_red_theta)
from .quadrotor import (SafetyFirstCost, obstacle_cost, obstacle_cost_single, quadrotor,
                        quadrotor_cost)

__all__ = ["PANDA_READY_POSE", "PLANTS", "PandaContext", "Plant", "QuadraticCost", "SafetyFirstCost", "cartpole_lmpc",
           "cartpole_lmpc_cost", "cartpole_virtual_collect_cost", "cartpole_virtual_cost",
           "cartpole_virtual_stabilized", "cartpole_virtual_swingup", "get_plant",
           "make_panda_context", "obstacle_cost", "obstacle_cost_single", "panda_context",
           "panda_cost", "panda_ee_velocity", "panda_fk", "panda_inverse_dynamics",
           "panda_inverse_dynamics_unrolled", "panda_link_transforms", "panda_mass_matrix",
           "panda_rbd", "panda_rbd_unrolled", "panda_surrogate", "quadrotor", "quadrotor_cost",
           "reference_mpc_cost", "rollout", "rollout_with_cost", "theta_to_red_theta"]

# the JAX package's registry (mpc_via_diffusion_model_tpu/dynamics/__init__.py), as far as ported
PLANTS = {
    "cartpole_lmpc": (cartpole_lmpc, cartpole_lmpc_cost),
    "cartpole_virtual_swingup": (cartpole_virtual_swingup, cartpole_virtual_cost),
    "cartpole_virtual_stabilized": (cartpole_virtual_stabilized, cartpole_virtual_cost),
    "quadrotor": (quadrotor, quadrotor_cost),
    "panda_surrogate": (panda_surrogate, panda_cost),
    "panda": (panda_rbd, panda_cost),
}
_NOT_PORTED = ("pendulum", "double_integrator", "acrobot")


def get_plant(name: str, **kwargs):
    """(plant, cost) by registry name. A plant of the JAX package's registry
    that is not ported yet raises ``NotImplementedError``; an unknown name
    ``ValueError``."""
    if name in _NOT_PORTED:
        raise NotImplementedError(f"the plant '{name}' is not ported yet (ROADMAP.md A5); the "
                                  f"port has {sorted(PLANTS)}")
    if name not in PLANTS:
        raise ValueError(f"unknown plant '{name}'; have {sorted(PLANTS)}")
    plant_fn, cost_fn = PLANTS[name]
    return plant_fn(**kwargs), cost_fn()
