"""Training: the CPS step and the LR schedules."""
from .cps import CPSTrainState, cps_init_phase, create_cps_state, make_cps_train_step
from .schedules import make_lr_schedule

__all__ = ["CPSTrainState", "cps_init_phase", "create_cps_state", "make_cps_train_step",
           "make_lr_schedule"]
