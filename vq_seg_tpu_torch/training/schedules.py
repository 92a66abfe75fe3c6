"""Learning-rate schedules, counterpart of the JAX package's
``training/schedules.py``, as plain ``step -> float`` functions.

The arithmetic is f32, as the JAX package's is: near the end of a cosine
schedule ``1 + cos`` cancels, and f64 would move the rate by up to 1e-5
relative against the reference.  The cosine schedule has no warmup ramp:
``warmup_steps`` only shortens its period (PARITY.md).  ``poly`` is
``warmup_poly`` without warmup; ``multistep`` decays x0.1 at each
milestone epoch.
"""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def warmup_poly(start_lr: float, lr_power: float, total_iters: int, warmup_steps: int):
    total = _f32(total_iters)

    def schedule(step) -> float:
        step = _f32(step)
        if warmup_steps > 0 and step < warmup_steps:
            return float(_f32(start_lr) * (step / _f32(warmup_steps)))
        return float(_f32(start_lr) * (_f32(1.0) - step / total) ** _f32(lr_power))

    return schedule


def cosine_annealing(start_lr: float, min_lr: float, total_iters: int, warmup_steps: int = 0):
    denom = _f32(float(total_iters) - float(warmup_steps))
    amp = _f32(0.5 * (start_lr - min_lr))

    def schedule(step) -> float:
        cos = np.cos(_f32(np.pi) * _f32(step) / denom)
        return float(_f32(min_lr) + amp * (_f32(1.0) + cos))

    return schedule


def multistep(start_lr: float, milestones):
    """x0.1 at each milestone step."""
    milestones = [int(m) for m in milestones]

    def schedule(step) -> float:
        power = sum(1 for m in milestones if step >= m)
        return float(_f32(start_lr) * _f32(0.1) ** _f32(power))

    return schedule


def make_lr_schedule(train_cfg, steps_per_epoch: int):
    """The schedule ``train_cfg.lr_scheduler`` names, over
    ``steps_per_epoch * train_cfg.num_epochs`` steps."""
    sched_cfg = train_cfg.lr_scheduler
    total_iters = steps_per_epoch * train_cfg.num_epochs
    lr = float(train_cfg.learning_rate)
    if sched_cfg.name == "warmuppoly":
        return warmup_poly(lr, sched_cfg.get("lr_power", 0.9), total_iters,
                           steps_per_epoch * sched_cfg.get("warmup_epoch", 0))
    if sched_cfg.name == "cosineannealing":
        return cosine_annealing(lr, sched_cfg.min_lr, total_iters,
                                sched_cfg.get("warmup_steps", 0))
    if sched_cfg.name == "poly":
        return warmup_poly(lr, sched_cfg.get("power", 0.9), total_iters, 0)
    if sched_cfg.name == "multistep":
        epochs = int(train_cfg.num_epochs)
        default = list(range(0, epochs, max(1, epochs // 3)))[1:]
        return multistep(lr, [int(m) * steps_per_epoch
                              for m in sched_cfg.get("milestones", default)])
    raise ValueError(f"unknown lr scheduler: {sched_cfg.name}")
