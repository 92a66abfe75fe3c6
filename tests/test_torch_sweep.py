"""Port parity: the TPE sweep (``training/sweep.py``) on the CPU.

  * ``TPESampler``'s proposals equal the JAX package's exactly for 20
    ask/tell rounds (8 startup draws, then the TPE branch) with a fixed
    objective of the parameters;
  * ``sweep`` with a stub objective gives the JAX package's best
    parameters, best value, history and JSON file exactly;
  * one ``make_cps_objective`` trial (the port's ``cps.train`` for one
    epoch of one step at resnet18 / K=8 / 64x64, then ``evaluate``) on a
    tiny tree gives a finite mIoU in [0, 1], and the trial's config is left
    as it was given; without ``device="cpu"`` and without a card the
    objective raises.
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import copy
import json
import math

import numpy as np
import pytest
import torch

from vq_seg_tpu.training import sweep as jsweep
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.training import sweep

torch.set_num_threads(1)


def _score(params):
    """A fixed objective of the parameters, peaked inside the space."""
    return (-(math.log10(params["train.learning_rate"]) + 4.0) ** 2
            - (params["train.cps_loss_weight"] - 1.2) ** 2
            + 0.1 * params["train.total_commitment_loss_weight"]
            - 0.05 * math.log10(params["train.total_prototype_loss_weight"]))


@pytest.mark.parametrize("seed", [0, 5])
def test_tpe_proposals_equal_jax(seed):
    assert sweep.DEFAULT_SPACE == jsweep.DEFAULT_SPACE
    port = sweep.TPESampler(sweep.DEFAULT_SPACE, seed=seed)
    ref = jsweep.TPESampler(jsweep.DEFAULT_SPACE, seed=seed)
    for _ in range(20):
        got, want = port.ask(), ref.ask()
        assert got == want
        port.tell(got, _score(got))
        ref.tell(want, _score(want))
    assert len(port.observations) == 20


def test_sweep_history_equals_jax(tmp_path):
    cfg = {"train": {"learning_rate": 1e-4, "total_commitment_loss_weight": 1.0,
                     "total_prototype_loss_weight": 0.01, "cps_loss_weight": 1.0}}
    seen = []

    def objective(trial_cfg):
        seen.append(copy.deepcopy(trial_cfg))
        return _score({f"train.{k}": v for k, v in trial_cfg["train"].items()})

    got = sweep.sweep(cfg, objective, n_trials=12, seed=3, n_startup=4,
                      out_path=str(tmp_path / "port.json"))
    want = jsweep.sweep(cfg, objective, n_trials=12, seed=3, n_startup=4,
                        out_path=str(tmp_path / "jax.json"))
    assert got == want
    assert json.load(open(tmp_path / "port.json")) == json.load(open(tmp_path / "jax.json"))
    assert cfg["train"]["learning_rate"] == 1e-4  # trials take copies
    assert seen[0] == seen[12] and seen[11] == seen[23]


def test_one_cps_objective_trial(synthetic_dataset, tmp_path):
    cfg = Config({
        "project_name": "sweep", "wandb_logging": True, "num_classes": 3,
        "pixel_to_label": {"0": 0, "128": 1, "255": 2}, "resize": 64,
        "model": {"name": "vqreptunet1x1v2", "params": {
            "encoder_name": "resnet18", "num_classes": 3,
            "vq_cfg": {"num_embeddings": [0, 0, 8, 8, 8], "distance": "euclidean",
                       "kmeans_init": True},
            "margin": 0.5, "scale": 30.0}},
        "train": {"data_dir": synthetic_dataset, "save_dir": str(tmp_path / "runs"),
                  "num_epochs": 3, "batch_size": 2, "learning_rate": 1e-4,
                  "lr_scheduler": {"name": "cosineannealing", "min_lr": 1e-7, "warmup_steps": 0},
                  "half": False, "criterion": {"name": "dice_loss"}, "cps_loss_weight": 1,
                  "total_commitment_loss_weight": 1, "total_prototype_loss_weight": 0.01,
                  "confidence_threshold": 0.7, "save_img": False, "save_txt": True},
        "test": {"data_dir": synthetic_dataset, "save_dir": str(tmp_path / "test"),
                 "batch_size": 1, "weights": None}})
    before = copy.deepcopy(cfg)
    objective = sweep.make_cps_objective(epochs=1, max_steps_per_epoch=1, device="cpu")
    value = objective(cfg)
    assert np.isfinite(value) and 0.0 <= value <= 1.0
    assert cfg == before
    assert not (tmp_path / "runs").exists()  # no checkpoints per trial


def test_objective_runs_on_the_card_by_default():
    """The objective, like every entry point, runs on "cuda" unless given
    ``device="cpu"``: without a card it raises before it trains."""
    cfg = Config({"train": {"num_epochs": 1}, "test": {}, "wandb_logging": False})
    objective = sweep.make_cps_objective(epochs=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            objective(cfg)
