"""A variant driver (``reptcps``) on a data-parallel mesh of 2 gloo CPU
processes through the CLI, and ``--mode selfsup`` under a mesh, at
resnet18 / K=8 / 64x64 on the tiny PNG tree of ``tests/conftest.py``.

One launch (``tests/_torch_dist_worker.py``) runs on 2 ranks ``python -m
vq_seg_tpu_torch.train --data_parallel --device cpu`` with
``config/vqreptunet1x1.json`` cut to size (global batch 2, 1 epoch of 2
steps, a test pass), then ``--mode selfsup --data_parallel`` with
``config/vqvaev2_selfsup.json`` cut to size.  The same ``reptcps`` config
runs in this process, single, meanwhile.
  * the epoch averages within 1e-5 relative of the single run's (IoUs 1e-3
    absolute: a pixel that flips moves them by about 1e-4), the test mIoU
    within 1e-3, the same steps, on both ranks;
  * one run directory, the main rank's, whose ``last.ckpt`` has the single
    run's keys, shapes and dtypes; a single process restores it
    (``restore_cps_state``) at the saved step and LR, and its next step's
    loss terms lie within 1e-5 of the single run's restored the same way;
  * ``--mode selfsup`` trains on the main rank alone, without a mesh (as
    the JAX CLI passes it none); the other rank idles and exits 0.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import _parallel_modes as pm
from _torch_dist_worker import start
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.training import cps, variant_drivers

torch.set_num_threads(1)

TERMS = ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "commitment_loss", "prototype_loss")


def _rept_cfg(data_dir, save_dir):
    cfg = json.load(open(os.path.join(pm.ROOT, "config", "vqreptunet1x1.json")))
    cfg.update(resize=pm.HW, wandb_logging=False, project_name="rept")
    params = cfg["model"]["params"]
    params["encoder_name"] = "resnet18"
    params.pop("encoder_weights", None)
    params["vq_cfg"]["num_embeddings"] = pm.NUM_EMB
    cfg["train"].update(data_dir=data_dir, save_dir=save_dir, batch_size=2, num_epochs=1,
                        test_every=1)
    cfg["test"].update(data_dir=data_dir)
    return cfg


def _selfsup_cfg(data_dir, save_dir):
    cfg = json.load(open(os.path.join(pm.ROOT, "config", "vqvaev2_selfsup.json")))
    cfg.update(resize=pm.HW, wandb_logging=False)
    cfg["model"]["params"]["encoder_name"] = "resnet18"
    cfg["model"]["params"]["vq_cfg"]["num_embeddings"] = pm.NUM_EMB
    cfg["train"].update(data_dir=os.path.join(data_dir, "train", "input"), save_dir=save_dir,
                        batch_size=2, num_epochs=1)
    return cfg


@pytest.fixture(scope="module")
def runs(synthetic_dataset, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("par_modes_driver")
    paths = {}
    for name, cfg in (("rept", _rept_cfg(synthetic_dataset, str(tmp / "runs2"))),
                      ("selfsup", _selfsup_cfg(synthetic_dataset, str(tmp / "selfsup2")))):
        paths[name] = str(tmp / f"{name}.json")
        json.dump(cfg, open(paths[name], "w"))
    argvs = [["--config_path", paths["rept"], "--mode", "reptcps", "--data_parallel",
              "--device", "cpu", "--max_steps_per_epoch", "2"],
             ["--config_path", paths["selfsup"], "--mode", "selfsup", "--data_parallel",
              "--device", "cpu", "--max_steps_per_epoch", "2"]]
    wait = start("cli", 2, str(tmp / "workers"), argvs=argvs,
                 drivers=["train_rept_cps", "train_selfsup"])
    single_cfg = _rept_cfg(synthetic_dataset, str(tmp / "runs1"))  # meanwhile, here
    history = []
    variant_drivers.train_rept_cps(Config(single_cfg), max_steps_per_epoch=2, device="cpu",
                                   history=history)
    results = wait()
    yield dict(results=results, single=history, tmp=tmp, cfg=single_cfg,
               data_dir=synthetic_dataset)
    shutil.rmtree(tmp, ignore_errors=True)  # the runs' checkpoints


def test_reptcps_cli_on_two_ranks_matches_one_process(runs):
    [single] = runs["single"]
    for rank in runs["results"]:
        rec = rank[0]
        assert rec["called"] and rec["mesh"] == (2, 1)
        [got] = rec["history"]
        assert got["step"] == single["step"] == 2
        for key in TERMS:
            np.testing.assert_allclose(got[key], single[key], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(got["miou"], single["miou"], atol=1e-3)
        assert single["test_miou"] is not None
        np.testing.assert_allclose(got["test_miou"], single["test_miou"], atol=1e-3)


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return type(tree)


def test_reptcps_checkpoint_is_the_single_contract_and_restores(runs):
    tmp = runs["tmp"]
    assert sorted(os.listdir(tmp / "runs2")) == ["rept_reptcps_0"]  # the main rank's only
    paths = {n: os.path.join(tmp, f"runs{n}", "rept_reptcps_0", "ckpoints", "last.ckpt")
             for n in (1, 2)}
    cks = {n: torch.load(p, weights_only=True) for n, p in paths.items()}
    assert cks[2].keys() == cks[1].keys() and cks[2]["epoch"] == 0
    assert _shapes(cks[2]) == _shapes(cks[1])
    # a single process restores each and takes one more step on one batch
    cfg = Config(runs["cfg"])
    batch = pm.global_batch(seed=5, n=2)
    out = {}
    for n, ck in cks.items():
        schedule = cps.make_lr_schedule(cfg.train, 2)
        state = variant_drivers.dual_state(cfg, schedule, "cpu")
        cps.restore_cps_state(state, ck)
        assert state.step == 2
        step = pm.make_step("reptcps", cfg, state)
        out[n] = step(state, batch[0], batch[1], batch[2], pm.DROP_PERCENT)[1]
        assert state.step == 3
        assert state.opt_1.param_groups[0]["lr"] == schedule(2)
    for key in TERMS:
        np.testing.assert_allclose(float(out[2][key]), float(out[1][key]), rtol=1e-5,
                                   err_msg=key)


def test_selfsup_under_a_mesh_trains_on_the_main_rank_only(runs):
    main, other = (rank[1] for rank in runs["results"])
    assert main["called"] and main["mesh"] is None and len(main["history"]) == 1
    assert not other["called"] and other["history"] == []
    assert os.listdir(runs["tmp"] / "selfsup2") == ["selfsup_ckpoints"]
