from .schedules import BETA_SCHEDULES, DiffusionSchedule, make_schedule

__all__ = ["BETA_SCHEDULES", "DiffusionSchedule", "make_schedule"]
