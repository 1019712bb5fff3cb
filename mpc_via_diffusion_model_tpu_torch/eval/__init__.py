from .timing import Timer, pipelined_time_fn, time_fn

__all__ = ["Timer", "pipelined_time_fn", "time_fn"]
