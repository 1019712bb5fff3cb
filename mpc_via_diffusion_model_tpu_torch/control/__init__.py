from .conditions import ConcatFeatures, PandaContext
from .metrics import count_swing_modes, per_step_mpc_costs, track_parity
from .runtime import (ClosedLoopResult, make_ampc_closed_loop, make_closed_loop,
                      make_nmpc_closed_loop, make_replan_fn)

__all__ = ["ClosedLoopResult", "ConcatFeatures", "PandaContext", "count_swing_modes", "make_ampc_closed_loop", "make_closed_loop",
           "make_nmpc_closed_loop", "make_replan_fn", "per_step_mpc_costs", "track_parity"]
