"""The port's CPS driver on a data-parallel mesh of 2 gloo CPU processes,
multi-device serving and the CLI's mesh checks, at resnet18 / K=8 / 64x64
on the tiny PNG tree of ``tests/conftest.py``.

One launch (``tests/_torch_dist_worker.py``) runs ``cps.train`` on 2 ranks
with ZeRO-1 (``train.zero_opt``) and global batch 2 for up to 2 epochs of
2 steps; rank 1 sends itself SIGTERM after its first step.  The same
config runs in this process, single, with a preemption requested before
it starts.  Both stop after epoch 0:
  * the epoch averages within 1e-5 relative (IoUs 1e-3 absolute: one pixel
    that flips moves them by about 1e-4), the test mIoU within 1e-3;
  * the 2-rank run's ``last.ckpt`` (Adam's state consolidated from the
    ZeRO shards) has the single run's keys, shapes and dtypes, and a
    single process resumes from it at the saved step and LR;
  * both ranks stopped after epoch 0, though only rank 1 was signalled.
"""
import copy
import os
import shutil

import numpy as np
import pytest
import torch

from _torch_dist_worker import start
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.parallel import Mesh, pad_to_devices, shard_batch_fn
from vq_seg_tpu_torch.parallel.distributed import host_shard
from vq_seg_tpu_torch.serving import Predictor
from vq_seg_tpu_torch.train import mesh_layout
from vq_seg_tpu_torch.training import cps
from vq_seg_tpu_torch.utils.preemption import PreemptionGuard

torch.set_num_threads(1)

HW = 64
NUM_EMB = [0, 0, 8, 8, 8]
MODEL_CFG = {"name": "vqreptunet1x1v2", "params": {
    "encoder_name": "resnet18", "num_classes": 3, "depth": 5,
    "vq_cfg": {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True},
    "margin": 0.5, "scale": 30.0}}
TERMS = ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "commitment_loss", "prototype_loss")


def _cfg(data_dir, save_dir):
    return {
        "project_name": "par", "wandb_logging": False, "num_classes": 3,
        "pixel_to_label": {"0": 0, "128": 1, "255": 2}, "resize": HW, "model": MODEL_CFG,
        "train": {"data_dir": data_dir, "save_dir": save_dir, "num_epochs": 2, "batch_size": 2,
                  "learning_rate": 1e-4,
                  "lr_scheduler": {"name": "cosineannealing", "min_lr": 1e-7, "warmup_steps": 0},
                  "half": False, "init_weights": True, "criterion": {"name": "dice_loss"},
                  "cps_loss_weight": 1, "total_commitment_loss_weight": 1,
                  "total_prototype_loss_weight": 0.01, "confidence_threshold": 0.7,
                  "resume": None, "save_img": False, "save_as_tar": False, "test_every": 1,
                  "light_snapshots": True},
        "test": {"data_dir": data_dir, "batch_size": 1, "weights": None},
    }


@pytest.fixture(scope="module")
def runs(synthetic_dataset, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("par_driver")
    cfg2 = _cfg(synthetic_dataset, str(tmp / "runs2"))
    cfg2["train"]["zero_opt"] = True  # the checkpoint is then ZeRO's, consolidated
    wait = start("train", 2, str(tmp / "workers"), cfg=cfg2, n_data=2, n_model=1,
                 sigterm_rank=1)
    cfg1 = _cfg(synthetic_dataset, str(tmp / "runs1"))  # meanwhile, in this process
    guard = PreemptionGuard()
    guard.request_stop()
    history = []
    cps.train(Config(cfg1), max_steps_per_epoch=None, preempt=guard, device="cpu",
              history=history)
    results = wait()
    ck = {name: torch.load(os.path.join(tmp, f"runs{n}", "par_hybrid_0", "ckpoints",
                                        "last.ckpt"), weights_only=True)
          for name, n in (("mesh", 2), ("single", 1))}
    yield dict(results=results, single=history, ck=ck, cfg=cfg1, tmp=tmp)
    shutil.rmtree(tmp, ignore_errors=True)  # the runs' checkpoints


def test_epoch_averages_and_test_miou_match_one_process(runs):
    [single] = runs["single"]
    for res in runs["results"]:
        [rec] = res["history"]
        assert rec["steps"] == single["steps"] == 2 and rec["step"] == single["step"] == 2
        for key in TERMS:
            np.testing.assert_allclose(rec[key], single[key], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(rec["miou"], single["miou"], atol=1e-3)
        np.testing.assert_allclose(rec["iou_list"], single["iou_list"], atol=1e-3)
        np.testing.assert_allclose(rec["code_usage"], single["code_usage"], atol=1e-5)
        assert rec["lr"] == single["lr"]
        assert single["test_miou"] is not None
        np.testing.assert_allclose(rec["test_miou"], single["test_miou"], atol=1e-3)


def test_checkpoint_is_the_single_contract_and_resumes_in_one_process(runs):
    mesh_ck, single_ck = runs["ck"]["mesh"], runs["ck"]["single"]
    assert mesh_ck.keys() == single_ck.keys()
    assert mesh_ck["epoch"] == 0

    def shapes(tree):
        if isinstance(tree, torch.Tensor):
            return (tuple(tree.shape), tree.dtype)
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [shapes(v) for v in tree]
        return type(tree)
    assert shapes(mesh_ck) == shapes(single_ck)
    cfg = copy.deepcopy(runs["cfg"])
    cfg["train"].update(resume=os.path.join(runs["tmp"], "runs2", "par_hybrid_0", "ckpoints",
                                            "last.ckpt"), save_dir=None, test_every=0)
    history = []
    cps.train(Config(cfg), max_steps_per_epoch=1, device="cpu", history=history)
    [rec] = history
    schedule = cps.make_lr_schedule(Config(cfg).train, 2)
    assert rec["epoch"] == 1 and rec["step_start"] == 2
    assert rec["lr_start"] == schedule(2)


def test_sigterm_on_one_rank_stops_every_rank_after_the_same_epoch(runs):
    """Rank 1 alone was signalled in epoch 0 of 2; both ranks end after it,
    and the run's ``last.ckpt`` is epoch 0's."""
    assert [len(res["history"]) for res in runs["results"]] == [1, 1]
    assert [res["history"][0]["epoch"] for res in runs["results"]] == [0, 0]
    assert "last.ckpt" in runs["results"][0]["history"][0]["ckpt_files"]


@pytest.mark.parametrize("devices", [["cpu", "cpu"], ["cpu", "cpu", "cpu", "cpu"]])
def test_predictor_on_a_mesh_of_devices(devices):
    """One replica per device, the batch split in order: exactly the single
    predictor's labels, a partial batch included, and through
    ``predict_stream``."""
    model = make_model(MODEL_CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(size=(4, 3, HW, HW)).astype(np.float32))
    model.init_codebook_(x, torch.Generator().manual_seed(1))
    imgs = [rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8) for n in (4, 3)]
    single = Predictor(model, input_hw=(HW, HW), batch_size=4, half=False, device="cpu")
    meshed = Predictor(model, input_hw=(HW, HW), batch_size=4, half=False, mesh=devices)
    assert len(meshed.replicas) == len(devices)
    for batch in imgs:
        np.testing.assert_array_equal(meshed(batch), single(batch))
    for a, b in zip(meshed.predict_stream(imgs), single.predict_stream(imgs)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="divide"):
        Predictor(model, input_hw=(HW, HW), batch_size=3, half=False, mesh=devices)


@pytest.mark.parametrize("flags,world,want,batch", [
    ({}, 4, None, 4),
    ({"data_parallel": True}, 4, (4, 1), 4),
    ({"data_parallel": True}, 8, (4, 1), 4),  # gcd(4, 8): 4 ranks idle, with a warning
    ({"data_parallel": True, "per_device_batch": True}, 8, (8, 1), 32),
    ({"pair_parallel": True}, 2, (1, 2), 4),
    ({"data_parallel": True, "pair_parallel": True}, 4, (2, 2), 4),
    ({"data_parallel": True, "pair_parallel": True, "per_device_batch": True}, 8, (4, 2), 16),
])
def test_mesh_layout_checks(flags, world, want, batch):
    cfg = Config({"resize": HW, "train": {"batch_size": 4}})
    assert mesh_layout(cfg, world_size=world, **flags) == want
    assert cfg.train.batch_size == batch


def test_mesh_layout_refusals():
    cfg = Config({"resize": HW, "train": {"batch_size": 4}})
    with pytest.raises(SystemExit, match="2 processes"):
        mesh_layout(cfg, pair_parallel=True, world_size=1)
    with pytest.raises(NotImplementedError, match="item 21"):
        mesh_layout(cfg, data_parallel=True, spatial=2, world_size=4)


def test_batch_and_item_sharding_keep_the_jax_layout():
    """Data rank d holds rows [d*b, (d+1)*b) of a global batch, as GSPMD
    lays it out over ``data``; ``host_shard`` and ``pad_to_devices`` keep
    their JAX meaning."""
    batch = torch.arange(12).reshape(6, 2)
    shards = [shard_batch_fn(Mesh(3, 1, (0, 1, 2), d, d, 0, None, None, None))(batch)
              for d in range(3)]
    assert torch.equal(torch.cat(shards), batch) and shards[1].tolist() == [[4, 5], [6, 7]]
    with pytest.raises(ValueError, match="divide"):
        shard_batch_fn(Mesh(4, 1, (0, 1, 2, 3), 0, 0, 0, None, None, None))(batch)
    assert host_shard(range(7), 1, 3) == [1, 4]
    assert [pad_to_devices(b, 4) for b in (1, 4, 5)] == [4, 4, 8]
