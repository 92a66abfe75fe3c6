"""Hyper-parameter sweep driver, counterpart of the JAX package's
``training/sweep.py`` (reference deprecated/optuna_vqptunet.py).

A self-contained Tree-structured Parzen Estimator with Optuna's surface:
startup trials are uniform draws; afterwards each parameter is the
candidate that maximises l(x)/g(x), where l models the best
``gamma``-quantile of the observations and g the rest with Gaussian Parzen
windows (in log space for log-scaled parameters).  The sampler draws from
``random.Random(seed)`` and ``np.random.default_rng(seed)`` in the JAX
package's order, so one seed proposes the same parameters in both.

``make_cps_objective`` builds a trainer-integrated objective: a short
flagship CPS training (the port's ``cps.train``) on the config's dataset,
scored by ``evaluate`` of model 1 on the test split::

    from vq_seg_tpu_torch.training.sweep import sweep, make_cps_objective
    best, value, hist = sweep(cfg, make_cps_objective(epochs=5), n_trials=20)
"""
from __future__ import annotations

import copy
import json
import math
import os
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

DEFAULT_SPACE = {
    # (low, high, log-scale), optuna_vqptunet.py:49-54
    "train.learning_rate": (1e-5, 1e-3, True),
    "train.total_commitment_loss_weight": (0.1, 2.0, False),
    "train.total_prototype_loss_weight": (1e-3, 1.0, True),
    "train.cps_loss_weight": (0.1, 2.0, False),
}


def _set_path(cfg, dotted: str, value):
    node = cfg
    parts = dotted.split(".")
    for p in parts[:-1]:
        node = node[p]
    node[parts[-1]] = value


def _to_unit(v, lo, hi, log):
    if log:
        return (math.log(v) - math.log(lo)) / (math.log(hi) - math.log(lo))
    return (v - lo) / (hi - lo)


def _from_unit(u, lo, hi, log):
    u = min(max(u, 0.0), 1.0)
    if log:
        return math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    return lo + u * (hi - lo)


class TPESampler:
    """Per-parameter univariate TPE (the independent-factor form Optuna
    defaults to).  Observations are kept in unit space."""

    def __init__(self, space: Dict[str, Tuple[float, float, bool]], seed: int = 0,
                 n_startup: int = 8, gamma: float = 0.25, n_candidates: int = 24):
        self.space = space
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.observations: List[Tuple[Dict[str, float], float]] = []

    def tell(self, params: Dict[str, float], value: float):
        self.observations.append((params, value))

    def _parzen_logpdf(self, xs: np.ndarray, obs: np.ndarray) -> np.ndarray:
        """log of a Parzen mixture over unit-space observations, with a
        uniform prior component and Scott's-rule bandwidth."""
        centers = np.concatenate([obs, [0.5]])
        bw = max(1.06 * (np.std(centers) + 1e-3) * len(centers) ** -0.2, 0.05)
        d = (xs[:, None] - centers[None, :]) / bw
        comp = -0.5 * d * d - math.log(bw * math.sqrt(2 * math.pi))
        m = comp.max(axis=1, keepdims=True)
        return m[:, 0] + np.log(np.exp(comp - m).mean(axis=1))

    def ask(self) -> Dict[str, float]:
        if len(self.observations) < self.n_startup:
            return {k: _from_unit(self.rng.random(), lo, hi, log)
                    for k, (lo, hi, log) in self.space.items()}
        obs = sorted(self.observations, key=lambda o: -o[1])  # maximise
        n_good = max(1, int(math.ceil(self.gamma * len(obs))))
        good, bad = obs[:n_good], obs[n_good:]
        out = {}
        for k, (lo, hi, log) in self.space.items():
            g = np.asarray([_to_unit(p[k], lo, hi, log) for p, _ in good])
            b = (np.asarray([_to_unit(p[k], lo, hi, log) for p, _ in bad]) if bad
                 else np.asarray([0.5]))
            # candidates drawn from l(x): perturbed good observations
            cand = np.clip(g[self.np_rng.integers(0, len(g), self.n_candidates)]
                           + self.np_rng.normal(0, 0.1, self.n_candidates), 0, 1)
            score = self._parzen_logpdf(cand, g) - self._parzen_logpdf(cand, b)
            out[k] = _from_unit(float(cand[int(np.argmax(score))]), lo, hi, log)
        return out


def sweep(cfg, objective: Callable, n_trials: int = 20,
          space: Optional[Dict[str, Tuple[float, float, bool]]] = None,
          seed: int = 0, n_startup: int = 8, out_path: Optional[str] = None):
    """Run ``n_trials`` trials of ``objective(trial_cfg) -> float`` (higher
    is better, e.g. test mIoU) under TPE; with ``out_path`` the best
    parameters, best value and history are rewritten as JSON after each
    trial.  Returns (best_params, best_value, history)."""
    space = space or DEFAULT_SPACE
    sampler = TPESampler(space, seed=seed, n_startup=n_startup)
    best_params, best_value = None, -float("inf")
    history = []
    for t in range(n_trials):
        params = sampler.ask()
        trial_cfg = copy.deepcopy(cfg)
        for k, v in params.items():
            _set_path(trial_cfg, k, v)
        value = float(objective(trial_cfg))
        sampler.tell(params, value)
        history.append({"trial": t, "params": params, "value": value})
        if value > best_value:
            best_params, best_value = params, value
        if out_path:
            with open(out_path, "w") as f:
                json.dump({"best_params": best_params, "best_value": best_value,
                           "history": history}, f, indent=2)
    return best_params, best_value, history


def make_cps_objective(epochs: int = 5, max_steps_per_epoch: Optional[int] = None,
                       device="cuda"):
    """Trainer-integrated objective: ``cps.train`` of the trial's config for
    ``epochs`` epochs (no checkpoints, no wandb), then the official-protocol
    test mIoU of model 1 (``evaluate`` over ``{cfg.test.data_dir}/test``,
    targets at native size)."""

    def objective(trial_cfg) -> float:
        from ..data import BaseDataset, Loader
        from . import cps

        trial_cfg = copy.deepcopy(trial_cfg)
        trial_cfg["train"]["num_epochs"] = epochs
        trial_cfg["train"]["save_dir"] = None  # no checkpoints per trial
        trial_cfg["wandb_logging"] = False
        state = cps.train(trial_cfg, max_steps_per_epoch=max_steps_per_epoch, device=device)
        test_ds = BaseDataset(os.path.join(trial_cfg["test"]["data_dir"], "test"), "labelled",
                              batch_size=1, resize=trial_cfg["resize"], target_resize=False)
        return cps.evaluate(state.model_1, Loader(test_ds, 1, device=device),
                            trial_cfg["pixel_to_label"], trial_cfg["num_classes"],
                            device=device)

    return objective
