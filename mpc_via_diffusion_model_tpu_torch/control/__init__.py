from .runtime import ClosedLoopResult, make_closed_loop, make_replan_fn

__all__ = ["ClosedLoopResult", "make_closed_loop", "make_replan_fn"]
