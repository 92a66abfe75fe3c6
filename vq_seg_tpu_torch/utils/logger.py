"""Experiment logging (reference utils/logger.py:7-134), the port's copy of
the JAX package's ``utils/logger.py``.

``BaseLogger``/``Logger``/``TestLogger``, ``list_to_separate_log``,
``dict_to_table_log`` and ``make_img_table``.  wandb is imported lazily; where it is not
installed, or its ``init`` fails, a logger with an ``offline_dir`` appends
one JSON line of scalars per ``logging`` call to
``{offline_dir}/{logger_name}.jsonl``.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np


def _try_wandb():
    try:
        import wandb  # noqa

        return wandb
    except Exception:
        return None


class BaseLogger:
    """(logger.py:7-53)."""

    def __init__(self, cfg, logger_name: str, project: Optional[str] = None,
                 offline_dir: Optional[str] = None):
        self.wandb = _try_wandb()
        self._offline_path = None
        if self.wandb is not None:
            try:
                self.wandb.init(project=project or cfg.project_name, name=logger_name)
                self.wandb.config.update(cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg))
            except Exception:
                self.wandb = None
        if self.wandb is None and offline_dir is not None:
            os.makedirs(offline_dir, exist_ok=True)
            self._offline_path = os.path.join(offline_dir, f"{logger_name}.jsonl")
        self.config_dict = dict()
        self.log_dict = dict()
        self.img_dict = None
        self.table_dict = None
        self.temp_dict = None

    def _merged(self):
        log_dict = self.log_dict.copy()
        for extra in (self.img_dict, self.table_dict, self.temp_dict):
            if extra:
                log_dict.update(extra)
        return log_dict

    def logging(self, epoch=None):
        log_dict = self._merged()
        if self.wandb is not None:
            self.wandb.log(log_dict, step=epoch)
        elif self._offline_path:
            scalars = {k: (float(v) if np.isscalar(v) or getattr(v, "ndim", 1) == 0
                           else str(type(v).__name__))
                       for k, v in log_dict.items() if v is not None}
            with open(self._offline_path, "a") as f:
                f.write(json.dumps({"epoch": epoch, **scalars}) + "\n")

    def config_update(self):
        if self.wandb is not None:
            self.wandb.config.update(self.config_dict, allow_val_change=True)

    def image_update(self, image: np.ndarray, caption: str):
        if self.wandb is not None:
            self.img_dict = {"example": self.wandb.Image(image, mode="RGB", caption=caption)}

    def table_update(self, name: str, columns: List, data: List):
        if self.wandb is not None:
            self.table_dict = {name: self.wandb.Table(columns=columns, data=data)}

    def temp_update(self, d: dict):
        self.temp_dict = d

    def finish(self):
        if self.wandb is not None:
            self.wandb.finish()


class Logger(BaseLogger):
    """Train logger with metric summaries (logger.py:55-83)."""

    def __init__(self, cfg, logger_name: str, offline_dir: Optional[str] = None):
        super().__init__(cfg, logger_name, offline_dir=offline_dir)
        for key in cfg.train.get("wandb_config", []):
            self.config_dict[key] = cfg.train[key]
        if self.wandb is not None:
            for i in cfg.train.get("wandb_metrics", []):
                if i == "loss":
                    self.wandb.define_metric(i, summary="min")
                if i in ("miou", "perplexity"):
                    self.wandb.define_metric(i, summary="max")
        for key in cfg.train.get("wandb_log", []):
            self.log_dict[key] = None


class TestLogger(BaseLogger):
    """(logger.py:85-112): logs into a fixed 'Test' project, no step."""

    def __init__(self, cfg, logger_name: str, offline_dir: Optional[str] = None):
        super().__init__(cfg, logger_name, project="Test", offline_dir=offline_dir)

    def logging(self, epoch=None):
        super().logging(None)


def list_to_separate_log(values: List, name: str):
    """[a, b] -> {name_0: a, name_1: b} (logger.py:116-120)."""
    return {f"{name}_{i}": item for i, item in enumerate(values)}


def dict_to_table_log(d: dict):
    wandb = _try_wandb()
    if wandb is None:
        return d
    return wandb.Table(data=[list(d.values())], columns=list(d.keys()))


def make_img_table(filename_list, img_list_1, img_list_2, columns):
    """A wandb table of (filename, image, image) rows, or None without
    wandb."""
    wandb = _try_wandb()
    if wandb is None:
        return None
    data = [[fn, wandb.Image(i1, mode="RGB"), wandb.Image(i2, mode="RGB")]
            for fn, i1, i2 in zip(filename_list, img_list_1, img_list_2)]
    return wandb.Table(data=data, columns=columns)
