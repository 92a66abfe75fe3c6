"""The shipped ``plaincps`` and ``objcps`` configs through the port's train
CLI with ``--device cpu`` at 64x64, one step each: resnet18 (with the
config's ``cca``/``ccavq`` prefix), convnext_tiny for the ConvNeXt config
and K=8 in place of the configs' resnet50, convnext_base and K=512, whose
widths the card runs in ``chip_smoke.py``.  The ``last.ckpt`` of each
network is served by ``Predictor.from_checkpoint`` and swept by the test
CLI; the checkpoints are deleted after each config."""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import json
import os
import shutil

import numpy as np
import pytest
import torch

from vq_seg_tpu_torch import test as test_cli
from vq_seg_tpu_torch import train as train_cli
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.serving import Predictor
from vq_seg_tpu_torch.utils import ckpoints

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 64
CONTRACT = {"model_1", "model_2", "epoch", "batch_idx", "optimizer_1", "optimizer_2"}
PLAIN = ("cps_vqv2", "cps_vqv2_kmeans_init", "cps_vqv2_kmeans_with_imagenet_weights",
         "cps_vqv2_match", "vq_", "vqcanet", "vqatunet", "vqcanetv2", "vqcanetv3", "vqcanetv4",
         "drsavqunet", "vqpatchunet", "vqsegheadnet", "vqcanet_convnext")
OBJ = ("vqcanet_obj_loss", "vqimdbnet")
# configs whose network another config already serves: the CLI trains them,
# serving and the sweep run once per network
SAME_NETWORK = ("cps_vqv2_kmeans_init", "cps_vqv2_kmeans_with_imagenet_weights",
                "cps_vqv2_match", "vq_", "vqcanet_obj_loss")
SMALL = {"resnet50": "resnet18", "ccaresnet50": "ccaresnet18",
         "ccavqresnet50": "ccavqresnet18", "convnext_base": "convnext_tiny"}


def _small_cfg(name, data_dir, save_dir):
    cfg = json.load(open(os.path.join(ROOT, "config", f"{name}.json")))
    cfg["resize"] = HW
    cfg["wandb_logging"] = False
    params = cfg["model"]["params"]
    params.update(encoder_name=SMALL[params["encoder_name"]], encoder_weights=None)
    params["vq_cfg"]["num_embeddings"] = [8 if k else 0 for k in params["vq_cfg"]["num_embeddings"]]
    cfg["train"].update(data_dir=data_dir, save_dir=save_dir, num_epochs=1, batch_size=2,
                        test_every=0)
    cfg["test"].update(data_dir=data_dir)
    return cfg


@pytest.mark.parametrize("name", PLAIN + OBJ)
def test_shipped_plain_and_obj_configs_through_the_cli(name, synthetic_dataset, tmp_path, capsys):
    mode = "objcps" if name in OBJ else "plaincps"
    cfg = _small_cfg(name, synthetic_dataset, str(tmp_path / "runs"))
    assert cfg["mode"] == mode  # the CLI takes the config's own mode
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    train_cli.main(["--config_path", str(path), "--max_steps_per_epoch", "1", "--device", "cpu"])
    assert f"[{mode}][Epoch0] " in capsys.readouterr().out
    [run] = os.listdir(tmp_path / "runs")
    assert run == f"{cfg['project_name']}_{mode}_0"
    assert sorted(os.listdir(tmp_path / "runs" / run / "ckpoints")) == ["0ep.ckpt", "last.ckpt"]
    last = str(tmp_path / "runs" / run / "ckpoints" / "last.ckpt")
    ck = ckpoints.load_full(last)
    assert set(ck) == CONTRACT and ck["epoch"] == 0
    if name in SAME_NETWORK:
        shutil.rmtree(tmp_path / "runs")
        return
    pred = Predictor.from_checkpoint(Config(cfg), last, device="cpu", batch_size=2, half=False)
    labels = pred(np.zeros((2, HW, HW, 3), np.uint8))
    assert labels.shape == (2, HW, HW) and int(labels.max()) < 3
    cfg["test"].update(weights=os.path.dirname(last), save_dir=str(tmp_path / "test"))
    best_path, best = test_cli.test(Config(cfg), save_img=False, device="cpu")
    assert best_path.endswith(".ckpt") and 0.0 <= best["test_miou"] <= 1.0
    shutil.rmtree(tmp_path / "runs")  # two full contracts
