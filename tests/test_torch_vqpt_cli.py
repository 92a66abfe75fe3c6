"""The ``vqpt``/``easyhard`` slice from its entry points on the CPU
(helpers in ``_vqpt_parity.py``):

  * the 7 shipped configs through the train CLI (one step at 64x64,
    resnet18 and K=8 in place of resnet50 and K=512, which the card runs in
    ``chip_smoke.py``); each network's ``last.ckpt`` served by
    ``Predictor.from_checkpoint`` and swept by the test CLI;
  * ``save_vqvae`` -> ``load_vqvae_pretrained`` round-trips the encoder
    and codebooks bitwise and leaves the rest; a codebook of another size
    is skipped with a warning;
  * without ``device="cpu"`` both drivers and the CLI raise on a machine
    without a card, before they write anything.
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from _vqpt_parity import CONFIGS, CONTRACT, HW, SAME_NETWORK, _drv_cfg
from vq_seg_tpu_torch import test as test_cli
from vq_seg_tpu_torch import train as train_cli
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.serving import Predictor
from vq_seg_tpu_torch.training import variant_drivers
from vq_seg_tpu_torch.utils import ckpoints

torch.set_num_threads(1)


def test_save_vqvae_round_trip(tmp_path):
    cfg = _drv_cfg("", "")["model"]
    src = make_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    ckpoints.save_vqvae(src, 7, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["7ep_codebook.ckpt", "7ep_decoder.ckpt",
                                            "7ep_encoder.ckpt"]
    assert sorted(ckpoints.load_full(str(tmp_path / "7ep_codebook.ckpt"))) == [
        "2.embedding", "3.embedding", "4.embedding"]
    dst = make_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    ckpoints.load_vqvae_pretrained(dst, str(tmp_path / "7ep_encoder.ckpt"),
                                   str(tmp_path / "7ep_codebook.ckpt"))
    s, d = src.state_dict(), dst.state_dict()
    loaded = [k for k in s if k.startswith(("core.encoder.", "core.codebooks."))]
    assert len(loaded) > 100 and all(torch.equal(s[k], d[k]) for k in loaded)
    for key in ("core.decoder.blocks.0.0.conv.weight", "segmentation_head.weight",
                "prototype_loss.embedding"):  # the rest stays as drawn
        assert not torch.equal(s[key], d[key]), key
    # a network whose one codebook has another size takes none of them
    other_cfg = copy.deepcopy(cfg)
    other_cfg["params"]["vq_cfg"]["num_embeddings"] = [0, 0, 0, 0, 4]
    other = make_model(other_cfg, device="cpu")
    with pytest.warns(UserWarning, match="no codebook"):
        ckpoints.load_vqvae_pretrained(other, str(tmp_path / "7ep_encoder.ckpt"),
                                       str(tmp_path / "7ep_codebook.ckpt"))



@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_configs_through_the_cli(name, synthetic_dataset, tmp_path, capsys):
    cfg = _drv_cfg(synthetic_dataset, str(tmp_path / "runs"), name, test_every=0)
    cfg["wandb_logging"] = False
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    train_cli.main(["--config_path", str(path), "--max_steps_per_epoch", "1", "--device", "cpu"])
    mode = cfg["mode"]
    assert f"[{mode}][Epoch0] " in capsys.readouterr().out
    [run] = os.listdir(tmp_path / "runs")
    assert run == f"{cfg['project_name']}_{mode}_0"
    last = str(tmp_path / "runs" / run / "ckpoints" / "last.ckpt")
    assert set(ckpoints.load_full(last)) == CONTRACT
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


@pytest.mark.parametrize("mode", ["vqpt", "easyhard"])
def test_entry_points_need_the_card(mode, synthetic_dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    name = "vq_pt_unet" if mode == "vqpt" else "vq_pt_unet_easyhard"
    cfg = _drv_cfg(synthetic_dataset, str(tmp_path / "runs"), name)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    train = (variant_drivers.train_vqpt_cps if mode == "vqpt"
             else variant_drivers.train_easyhard_cps)
    for call in (lambda: train(Config(copy.deepcopy(cfg))),
                 lambda: train_cli.main(["--config_path", str(path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not os.path.exists(tmp_path / "runs")
