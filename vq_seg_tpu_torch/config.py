"""Config system: JSON/YAML -> attribute-access dict, reference schema.

The port keeps its own copy so that it reads ``config/*.json`` without
importing the JAX package.  A ``Config`` is a recursive attribute-access
mapping (the reference used ``EasyDict``).
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Mapping

import numpy as np


class Config(dict):
    """Recursive attribute-access dict (drop-in for the reference's EasyDict)."""

    def __init__(self, d: Mapping[str, Any] | None = None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, Config):
            return v
        if isinstance(v, Mapping):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return type(v)(Config._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, Config._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v

        return unwrap(self)


def load_config(path: str) -> Config:
    """Load a config file (.json or .yaml/.yml) into a Config."""
    ext = os.path.splitext(path)[1].lower()
    with open(path, "r") as f:
        if ext == ".json":
            raw = json.load(f)
        elif ext in (".yaml", ".yml"):
            import yaml  # optional dependency

            raw = yaml.safe_load(f)
        else:
            raise ValueError(f"unsupported config extension: {ext}")
    return Config(raw)


def pixel_to_label_lut(pixel_to_label: Mapping[str, int], num_entries: int = 256):
    """Build a 256-entry grayscale-pixel -> class-id lookup table.

    Mask pixel values {0: bg, 128: weed, 255: crop} map to class ids;
    unlisted pixel values map to themselves.
    """
    lut = np.arange(num_entries, dtype=np.int32)
    for k, v in pixel_to_label.items():
        lut[int(k)] = int(v)
    return lut
