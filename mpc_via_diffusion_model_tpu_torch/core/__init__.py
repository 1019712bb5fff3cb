from .losses import LOSSES, weighted_l1, weighted_l2
from .schedules import BETA_SCHEDULES, DiffusionSchedule, make_schedule

__all__ = ["BETA_SCHEDULES", "DiffusionSchedule", "LOSSES", "make_schedule", "weighted_l1",
           "weighted_l2"]
