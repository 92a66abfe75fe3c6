"""Training: the flagship's CPS step, its driver and evaluation; the
``reptcps``, ``plaincps``, ``objcps``, ``vqpt``, ``easyhard``,
``angularv3``, ``supconcps``, ``semiweed``, ``unimatch`` and ``salientcps``
steps and drivers; the supervised and ``selfsup`` steps and drivers; the
LR schedules."""
from .cps import (CPSTrainState, ckpt_cadence, cps_init_phase, create_cps_state, evaluate,
                  make_cps_train_step, restore_cps_state, train)
from .schedules import make_lr_schedule
from .selfsup import make_selfsup_train_step
from .selfsup import train as train_selfsup
from .supervised import make_sup_train_step
from .supervised import train as train_sup
from .variant_drivers import (angularv3_threshold, easyhard_draws, plain_init_phase, plain_step,
                              salient_step, semiweed_draws, train_angularv3_cps,
                              train_easyhard_cps, train_obj_cps, train_plain_cps, train_rept_cps,
                              train_salient_cps, train_semiweed, train_supcon_cps,
                              train_unimatch, train_vqpt_cps, unimatch_draws, vqpt_init_phase,
                              vqpt_step)
from .variants import (make_angularv3_cps_train_step, make_easyhard_cps_train_step,
                       make_objloss_cps_train_step, make_plain_cps_train_step,
                       make_rept_cps_train_step, make_salient_cps_train_step,
                       make_semiweed_train_step, make_supcon_cps_train_step,
                       make_unimatch_train_step, make_vqpt_cps_train_step,
                       overlapped_patches)

__all__ = ["CPSTrainState", "angularv3_threshold", "ckpt_cadence", "cps_init_phase",
           "create_cps_state", "easyhard_draws", "evaluate", "make_angularv3_cps_train_step",
           "make_cps_train_step", "make_easyhard_cps_train_step", "make_lr_schedule",
           "make_objloss_cps_train_step", "make_plain_cps_train_step",
           "make_rept_cps_train_step", "make_salient_cps_train_step", "make_selfsup_train_step",
           "make_semiweed_train_step", "make_sup_train_step", "make_supcon_cps_train_step",
           "make_unimatch_train_step", "make_vqpt_cps_train_step", "overlapped_patches",
           "plain_init_phase", "plain_step", "restore_cps_state", "salient_step",
           "semiweed_draws", "train", "train_angularv3_cps", "train_easyhard_cps",
           "train_obj_cps", "train_plain_cps", "train_rept_cps", "train_salient_cps",
           "train_selfsup", "train_semiweed", "train_sup", "train_supcon_cps",
           "train_unimatch", "train_vqpt_cps", "unimatch_draws", "vqpt_init_phase",
           "vqpt_step"]
