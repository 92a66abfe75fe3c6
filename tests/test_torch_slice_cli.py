"""The ``angularv3``/``supconcps``/``semiweed``/``selfsup`` slice from its
entry points on the CPU (helpers in ``_slice_parity.py``):

  * the five shipped configs through the train CLI (one step at 64x64,
    resnet18 and K=8 in place of resnet50 and K=512, which the card runs
    in ``chip_smoke.py``); each network's ``last.ckpt`` served by
    ``Predictor.from_checkpoint`` and swept by the test CLI;
  * the users' flow: ``--mode selfsup`` writes the VQ-VAE's files, and a
    ``vqpt`` run with ``train.pretrained`` naming them loads its encoder
    bitwise and keeps it frozen;
  * ``unimatch`` and ``salientcps`` (no shipped config: ``semiweednet.json``
    and ``vqreptunet1x1v2.json`` with the network swapped) train one CPU
    epoch through the train CLI and write their ``last.ckpt``; without
    ``device="cpu"`` the drivers of this slice and of the last one
    (``unimatch``, ``salientcps``, ``sup`` on ``obia_CWFID.json``, ``cps``
    of ``nopt``) raise on a machine without a card, before they write
    anything.
"""
import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from _slice_parity import HW, drv_cfg, salient_cfg, unimatch_cfg, write_saliency
from vq_seg_tpu_torch import test as test_cli
from vq_seg_tpu_torch import train as train_cli
from vq_seg_tpu_torch import training
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.serving import Predictor
from vq_seg_tpu_torch.utils import ckpoints

torch.set_num_threads(1)

DUAL = {"model_1", "model_2", "epoch", "batch_idx", "optimizer_1", "optimizer_2"}
CONFIGS = {"vqreptunetangularv3": DUAL, "vqreptunetangular": DUAL, "sup_con_loss": DUAL,
           "semiweednet": {"model_1", "epoch", "optimizer_1"}}


def _write(cfg, tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shipped_configs_through_the_cli(name, synthetic_dataset, tmp_path, capsys):
    extra = {"overlap_size": 24} if name == "semiweednet" else {}
    cfg = drv_cfg(synthetic_dataset, str(tmp_path / "runs"), name, test_every=0, **extra)
    cfg["wandb_logging"] = False
    train_cli.main(["--config_path", _write(cfg, tmp_path), "--max_steps_per_epoch", "1",
                    "--device", "cpu"])
    mode = cfg["mode"]
    assert f"[{mode}][Epoch0] " in capsys.readouterr().out
    [run] = os.listdir(tmp_path / "runs")
    assert run == f"{cfg['project_name']}_{mode}_0"
    last = str(tmp_path / "runs" / run / "ckpoints" / "last.ckpt")
    assert set(ckpoints.load_full(last)) == CONFIGS[name]
    pred = Predictor.from_checkpoint(Config(cfg), last, device="cpu", batch_size=2, half=False)
    labels = pred(np.zeros((2, HW, HW, 3), np.uint8))
    assert labels.shape == (2, HW, HW) and int(labels.max()) < 3
    cfg["test"].update(weights=os.path.dirname(last), save_dir=str(tmp_path / "test"))
    best_path, best = test_cli.test(Config(cfg), save_img=False, device="cpu")
    assert best_path.endswith(".ckpt") and 0.0 <= best["test_miou"] <= 1.0
    shutil.rmtree(tmp_path / "runs")


def test_selfsup_files_pretrain_a_vqpt_run(synthetic_dataset, tmp_path, capsys):
    cfg = drv_cfg(synthetic_dataset, str(tmp_path / "selfsup"), "vqvaev2_selfsup")
    cfg["train"]["data_dir"] = os.path.join(synthetic_dataset, "train", "input")
    train_cli.main(["--config_path", _write(cfg, tmp_path), "--max_steps_per_epoch", "1",
                    "--device", "cpu"])
    assert "[Epoch0] " in capsys.readouterr().out
    ck_dir = tmp_path / "selfsup" / "selfsup_ckpoints"
    assert sorted(os.listdir(ck_dir)) == ["0ep_codebook.ckpt", "0ep_decoder.ckpt",
                                          "0ep_encoder.ckpt"]
    files = {p: str(ck_dir / f"0ep_{p}.ckpt") for p in ("encoder", "codebook")}
    vqpt = drv_cfg(synthetic_dataset, str(tmp_path / "vqpt"), "vq_pt_unet", test_every=0,
                   pretrained=files)
    state = training.train_vqpt_cps(Config(vqpt), max_steps_per_epoch=1, device="cpu")
    enc = ckpoints.load_full(files["encoder"])
    cbs = ckpoints.load_full(files["codebook"])
    for model in (state.model_1, state.model_2):
        sd = model.core.encoder.state_dict()
        params = dict(model.core.encoder.named_parameters())
        assert all(torch.equal(sd[k], enc[k]) for k in params)  # frozen as loaded
        cb = model.core.codebooks.state_dict()
        assert sorted(cb) == sorted(cbs) and all(torch.equal(cb[k], cbs[k]) for k in cb)
    shutil.rmtree(tmp_path / "vqpt")


def _cfg(name, data_dir, save_dir, tmp_path, **train):
    """A tiny config by shipped name, or ``unimatch``/``salientcps`` (with
    saliency maps written under ``tmp_path``), ``obia_CWFID`` (fcn32s on
    vgg11) or ``nopt`` (the flagship's config with the name swapped)."""
    if name == "unimatch":
        return unimatch_cfg(data_dir, save_dir, **train)
    if name == "salientcps":
        return salient_cfg(data_dir, save_dir, str(tmp_path / "salient"), **train)
    if name == "nopt":
        cfg = drv_cfg(data_dir, save_dir, "vqreptunet1x1v2", **train)
        cfg["model"]["name"] = "nopt"
        return cfg
    cfg = drv_cfg(data_dir, save_dir, name, **train)
    if name == "obia_CWFID":
        cfg["model"]["params"]["encoder_name"] = "vgg11"
    return cfg


@pytest.mark.parametrize("mode", ["unimatch", "salientcps"])
def test_unported_modes_raise(mode, synthetic_dataset, tmp_path, capsys):
    """(Once pinned that the two modes raise.)  Each mode trains one CPU
    epoch through the train CLI, as a user runs it, and writes its
    ``last.ckpt``."""
    if mode == "salientcps":
        write_saliency(synthetic_dataset, str(tmp_path / "salient"))
    cfg = _cfg(mode, synthetic_dataset, str(tmp_path / "runs"), tmp_path)
    cfg["wandb_logging"] = False
    train_cli.main(["--config_path", _write(cfg, tmp_path), "--mode", mode,
                    "--max_steps_per_epoch", "1", "--device", "cpu"])
    assert f"[{mode}][Epoch0] " in capsys.readouterr().out
    [run] = os.listdir(tmp_path / "runs")
    assert run == f"{cfg['project_name']}_{mode}_0"
    last = str(tmp_path / "runs" / run / "ckpoints" / "last.ckpt")
    keys = {"model_1", "epoch", "optimizer_1"} if mode == "unimatch" else DUAL
    assert set(ckpoints.load_full(last)) == keys
    shutil.rmtree(tmp_path / "runs")


@pytest.mark.parametrize("driver,name", [("train_angularv3_cps", "vqreptunetangularv3"),
                                         ("train_supcon_cps", "sup_con_loss"),
                                         ("train_semiweed", "semiweednet"),
                                         ("train_selfsup", "vqvaev2_selfsup"),
                                         ("train_unimatch", "unimatch"),
                                         ("train_salient_cps", "salientcps"),
                                         ("train_sup", "obia_CWFID"),
                                         ("train", "nopt")])
def test_entry_points_need_the_card(driver, name, synthetic_dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = _cfg(name, synthetic_dataset, str(tmp_path / "runs"), tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(training, driver)(Config(copy.deepcopy(cfg)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--config_path", _write(cfg, tmp_path)])
    assert not os.path.exists(tmp_path / "runs")
