"""Profiler traces and a throughput meter, counterpart of the JAX
package's ``utils/profiling.py``.

  * ``trace(logdir)`` — a ``torch.profiler.profile`` over the host and, on
    the card, the device, that writes a Chrome/TensorBoard trace
    (``*.pt.trace.json``) of the work inside it into ``logdir``;
  * ``annotate(name)`` — ``torch.profiler.record_function``: a named region
    on the trace's timeline;
  * ``StepMeter`` — wall-clock images/s with exponential smoothing and a
    ``summary()`` dict for the logger.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Optional

import torch


@contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepMeter:
    """Tracks step wall-clock and images/sec (call ``tick`` after each
    synchronised step)."""

    def __init__(self, images_per_step: int, smoothing: float = 0.9):
        self.images_per_step = images_per_step
        self.smoothing = smoothing
        self._last: Optional[float] = None
        self._ema: Optional[float] = None
        self.steps = 0
        self.total_time = 0.0

    def start(self):
        self._last = time.perf_counter()

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.total_time += dt
            self.steps += 1
            self._ema = dt if self._ema is None else (
                self.smoothing * self._ema + (1 - self.smoothing) * dt)
        self._last = now

    @property
    def images_per_sec(self) -> float:
        if not self._ema:
            return 0.0
        return self.images_per_step / self._ema

    def summary(self) -> dict:
        avg = self.total_time / max(self.steps, 1)
        return {
            "steps": self.steps,
            "sec_per_step": avg,
            "images_per_sec": self.images_per_step / avg if avg else 0.0,
            "images_per_sec_ema": self.images_per_sec,
        }
