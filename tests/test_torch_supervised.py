"""Port parity: the supervised slice (``--mode sup``) against the JAX
package, f32 on the CPU, at resnet18 / K=8 / 64x64, batch 2.

JAX's random draws (weights, k-means) cannot be matched, so the port
starts from JAX's variables, mapped by ``state_dict_from_flax``.  The
weights come from a numpy seed (``_seeded_flax``) rather than from flax's
init, whose random draws compile one by one.

Bounds:
  * ``NormalizedDataset``: items equal to the JAX package's.
  * ``unet`` and ``vqunet_v2``, eval and train forwards: out within 1e-4
    (``vqunet_v2``'s softmax within 1e-5), commit within 1e-5 relative,
    usage equal, BN running stats within 1e-5.
  * the init phase: ``unet`` untouched, as JAX's; ``vqunet_v2``'s encoder
    BN running stats within 1e-5 of JAX's, each codebook the k-means of
    its stage's features replayed from the port's generator.
  * one supervised step of each network against ``make_sup_train_step``
    run with an optax transformation that keeps the gradient: metrics
    within 1e-4 relative (IoUs also 1e-4 absolute), the prediction within
    1e-4, every gradient within 1e-3 relative L2 of JAX's f32 gradient (a
    train-mode forward: flax's one-pass batch variance puts JAX's own f32
    gradients about 1e-4 from f64, ``tests/test_torch_training.py``),
    BN running stats within 1e-5.
  * one driver epoch of ``vqunet_v2`` (``only_sup_kmeans.json``'s
    settings) against JAX's ``train`` on the same PNG tree, the port
    starting from JAX's post-init state: epoch averages within 1e-3
    relative (IoUs 1e-3 absolute), the same run directory and
    ``last.ckpt`` = ``{"model_1", "epoch"}``.
  * each shipped ``sup`` config (``obia_CWFID.json`` aside, which raises)
    through the train CLI with ``--device cpu`` at 64x64, one step
    (resnet18 and K=8 in place of resnet50 and K=512); the ``last.ckpt`` of
    each network served by ``Predictor.from_checkpoint`` and swept by the
    test CLI.
"""
import copy
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vq_seg_tpu.config import Config as JaxConfig
from vq_seg_tpu.data import dataset as jds
from vq_seg_tpu.data import fastimg as jfastimg
from vq_seg_tpu.losses import make_loss as jax_make_loss
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import supervised as jsup
from vq_seg_tpu.utils.ckpoints import load_full as jax_load_full
from _seeded_flax import seeded_variables
from vq_seg_tpu_torch import test as test_cli
from vq_seg_tpu_torch import train as train_cli
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.data import NormalizedDataset, OBIADataset
from vq_seg_tpu_torch.losses import make_loss
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.ops.kmeans import kmeans_step, sample_vectors
from vq_seg_tpu_torch.serving import Predictor
from vq_seg_tpu_torch.training import supervised
from vq_seg_tpu_torch.utils import ckpoints
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax, sup_state_from_flax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, B = 64, 2
NUM_EMB = [0, 0, 8, 8, 8]
METRICS = ("loss", "sup_loss", "commitment_loss", "prototype_loss", "miou", "iou_list",
           "code_usage")
SUP_CONFIGS = ("CWFID_Unet", "IJRR2017_Unet", "rice_s_n_w_Unet", "only_sup_kmeans")
# configs that differ from CWFID_Unet only in paths and project name: the CLI
# trains them, serving and the sweep run once
DATA_VARIANTS = ("IJRR2017_Unet", "rice_s_n_w_Unet")


def _model_cfg(name):
    params = {"encoder_name": "resnet18", "num_classes": 3}
    if name == "vqunet_v2":
        params["vq_cfg"] = {"num_embeddings": NUM_EMB, "distance": "euclidean",
                            "kmeans_init": True}
    return {"name": name, "params": params}


def _num_emb(name):
    return NUM_EMB if name == "vqunet_v2" else None


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _batch(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(B, HW, HW, 3)).astype(np.float32)
    lab = ((np.arange(HW)[None, :, None] // 8 + rng.integers(0, 2, size=(B, HW, HW))) % 3)
    return img, lab.astype(np.int32)


def _outputs(out):
    """(pred, commit, usage) of a bare-logits or tuple output."""
    if isinstance(out, tuple):
        return out[0], out[1], out[2]
    return out, None, None


def _seeded_state(model, tx, sample_args, seed: int = 0):
    """The JAX package's ``create_state`` with the variables drawn from a
    numpy seed."""
    v = seeded_variables(model, sample_args, seed, train=True)
    return jsup.TrainState(variables=v, opt_state=tx.init(v["params"]),
                           step=jnp.zeros((), jnp.int32))


def _check_running(model, variables, num_emb):
    want = state_dict_from_flax(variables, num_emb)
    for key, t in model.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=key)


def test_normalized_dataset_matches_jax(synthetic_dataset):
    root = os.path.join(synthetic_dataset, "train")
    jset = jds.NormalizedDataset(root, "labelled", batch_size=2, resize=HW, mean=0.4, std=0.3)
    tset = NormalizedDataset(root, "labelled", batch_size=2, resize=HW, mean=0.4, std=0.3)
    assert tset.filenames == jset.filenames
    for i in range(len(tset)):
        got, want = tset[i], jset[i]
        assert got["filename"] == want["filename"]
        np.testing.assert_array_equal(got["target"], want["target"])
        np.testing.assert_array_equal(got["img"], want["img"])
        assert got["img"].dtype == np.float32 and 0.0 <= got["img"].min() <= got["img"].max() <= 1.0


@pytest.mark.parametrize("name", ["unet", "vqunet_v2"])
def test_network_forwards_match_jax(name):
    x, _ = _batch(1)
    jmodel = jax_make_model(_model_cfg(name))
    v = seeded_variables(jmodel, (jnp.asarray(x),), train=True)
    model = make_model(_model_cfg(name), device="cpu")
    model.load_state_dict(state_dict_from_flax(v, _num_emb(name)))
    atol = 1e-5 if name == "vqunet_v2" else 1e-4  # a softmax output
    for train in (False, True):
        if train:
            jout, mut = jmodel.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
            out = model.train()(_nchw(x), train=True)
        else:
            jout = jmodel.apply(v, jnp.asarray(x), train=False)
            with torch.no_grad():
                out = model.eval()(_nchw(x))
        (jpred, jcommit, jusage), (pred, commit, usage) = _outputs(jout), _outputs(out)
        assert tuple(pred.shape) == (B, 3, HW, HW)
        np.testing.assert_allclose(pred.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jpred),
                                   atol=atol)
        if name == "vqunet_v2":
            np.testing.assert_allclose(commit.item(), float(jcommit), rtol=1e-5, atol=1e-7)
            assert (commit.item() > 0) == train
            np.testing.assert_array_equal(usage.numpy(), np.asarray(jusage))
    _check_running(model, {**v, "batch_stats": _np(mut["batch_stats"])}, _num_emb(name))


@pytest.mark.parametrize("name", ["unet", "vqunet_v2"])
def test_init_phase(name):
    x, _ = _batch(2)
    jmodel = jax_make_model(_model_cfg(name))
    pre = _seeded_state(jmodel, optax.sgd(1.0), (jnp.asarray(x),))
    post = _np(jsup.init_phase(jmodel, pre, (jnp.asarray(x),)))
    st = supervised.create_state(_model_cfg(name), lambda s: 1.0, device="cpu")
    sup_state_from_flax(st, _np(pre), _num_emb(name))
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    supervised.init_phase(st, (_nchw(x),), seed=0)
    assert st.model.training  # left as found
    sd = st.model.state_dict()
    if name == "unet":  # no codebook: nothing runs, as in JAX
        assert all(torch.equal(sd[k], before[k]) for k in sd)
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            np.array_equal, post.variables, _np(pre).variables))
        return
    want = state_dict_from_flax(post.variables, NUM_EMB)
    enc = [k for k in sd if k.startswith("core.encoder.") and "running" in k]
    assert enc
    for key in enc:
        np.testing.assert_allclose(sd[key].numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    # each codebook is the k-means of its stage's train-mode features,
    # replayed from the generator the init phase draws from, stage by stage
    generator = torch.Generator().manual_seed(0)
    model = copy.deepcopy(st.model)
    model.load_state_dict(before)
    with torch.no_grad():
        feats = model.train().core.encoder(_nchw(x))[1:]
    for i, f in enumerate(feats):
        if NUM_EMB[i] == 0:
            continue
        rows = f.permute(0, 2, 3, 1).reshape(-1, f.shape[1])
        table = sd[f"core.codebooks.{i}.embedding"]
        means = sample_vectors(rows, table.shape[0], generator)
        for _ in range(10):
            means, _ = kmeans_step(rows, means)
        np.testing.assert_allclose(means.numpy(), table.numpy(), rtol=1e-5, atol=1e-6)


def _gradient_tx():
    """Updates nothing and keeps the last gradient as its state."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)
    return optax.GradientTransformation(zeros, lambda grads, state, params=None: (zeros(grads), grads))


@pytest.mark.parametrize("name", ["unet", "vqunet_v2"])
def test_one_sup_step_matches_jax(name):
    x, gt = _batch(3)
    jmodel = jax_make_model(_model_cfg(name))
    tx = _gradient_tx()
    jstate = jsup.init_phase(jmodel, _seeded_state(jmodel, tx, (jnp.asarray(x),)),
                             (jnp.asarray(x),))
    pre = _np(jstate)
    dice = jax_make_loss("dice_loss", 3, ignore_index=255)
    jstep = jsup.make_sup_train_step(jmodel, tx, dice, num_classes=3, forward_mode="plain")
    jnew, jm, jpred = jstep(jstate, jnp.asarray(x), jnp.asarray(gt), None)
    jnew, jm = _np(jnew), _np(jm)

    st = supervised.create_state(_model_cfg(name), lambda s: 1.0, device="cpu")
    sup_state_from_flax(st, pre, _num_emb(name))
    step = supervised.make_sup_train_step(make_loss("dice_loss", 3, ignore_index=255),
                                          num_classes=3, forward_mode="plain")
    st, m, pred = step(st, _nchw(x), torch.from_numpy(gt).long(), None)
    for key in METRICS:
        np.testing.assert_allclose(m[key].numpy(), jm[key], rtol=1e-4, atol=1e-4, err_msg=key)
    np.testing.assert_allclose(pred.permute(0, 2, 3, 1).numpy(), np.asarray(jpred), atol=1e-4)
    jg = state_dict_from_flax({**jnew.variables, "params": jnew.opt_state}, _num_emb(name))
    for pname, p in st.model.named_parameters():
        assert _rel(p.grad.numpy(), jg[pname].numpy()) <= 1e-3, pname
    _check_running(st.model, jnew.variables, _num_emb(name))
    assert st.step == 1


# -- the driver -------------------------------------------------------------------------


def _drv_cfg(name, data_dir, save_dir, **train):
    cfg = json.load(open(os.path.join(ROOT, "config", f"{name}.json")))
    cfg["resize"] = HW
    params = cfg["model"]["params"]
    params.update(encoder_name="resnet18", encoder_weights=None)
    if "vq_cfg" in params:
        params["vq_cfg"]["num_embeddings"] = NUM_EMB
    cfg["train"].update(data_dir=data_dir, save_dir=save_dir, num_epochs=1, batch_size=2,
                        **{"half": False, **train})
    return cfg


def _listing(run_dir):
    """Paths under ``run_dir``, a checkpoint counted once (the JAX package
    writes each as a directory)."""
    return sorted(os.path.relpath(os.path.join(d, n), run_dir)
                  for d, dirs, files in os.walk(run_dir) for n in dirs + files
                  if ".ckpt" not in os.path.relpath(d, run_dir))


@pytest.fixture(scope="module")
def sup_runs(synthetic_dataset, tmp_path_factory):
    """JAX's ``train`` of ``only_sup_kmeans`` for one epoch of 2 steps,
    then the port's from JAX's post-init state."""
    base = tmp_path_factory.mktemp("sup")
    captured = {}
    real_init = jsup.init_phase

    def jax_init(model, state, args, *a, **k):
        st = real_init(model, state, args, *a, **k)
        captured["post"] = _np(st)
        return st

    # the JAX package's fastimg.load() gives None to a decode thread that
    # asks while another thread loads the library, and that item then
    # decodes through PIL (up to 2/255 off): load it before its loader runs
    jfastimg.load()
    mp = pytest.MonkeyPatch()
    mp.setattr(jsup, "init_phase", jax_init)
    mp.setattr(jsup, "create_state", _seeded_state)
    try:
        jsup.train(JaxConfig(_drv_cfg("only_sup_kmeans", synthetic_dataset, str(base / "jax"))),
                   max_steps_per_epoch=2)
    finally:
        mp.undo()

    def port_init(state, args, **k):
        return sup_state_from_flax(state, captured["post"], NUM_EMB)

    mp.setattr(supervised, "init_phase", port_init)
    history = []
    try:
        state = supervised.train(
            Config(_drv_cfg("only_sup_kmeans", synthetic_dataset, str(base / "port"))),
            max_steps_per_epoch=2, device="cpu", history=history)
    finally:
        mp.undo()
    yield dict(state=state, history=history, jax_run=str(base / "jax" / "only_sup_kmeans_sup_0"),
               port_run=str(base / "port" / "only_sup_kmeans_sup_0"))
    shutil.rmtree(base, ignore_errors=True)


def test_driver_epoch_matches_jax(sup_runs):
    jrun, prun = sup_runs["jax_run"], sup_runs["port_run"]
    assert _listing(jrun) == _listing(prun) == [
        "ckpoints", "ckpoints/last.ckpt", "only_sup_kmeans_sup_0.jsonl"]
    [jrec] = [json.loads(line) for line in open(os.path.join(jrun, "only_sup_kmeans_sup_0.jsonl"))]
    [rec] = [json.loads(line) for line in open(os.path.join(prun, "only_sup_kmeans_sup_0.jsonl"))]
    assert set(rec) == set(jrec)
    for k in rec:
        tol = dict(atol=1e-3) if k == "miou" else dict(rtol=1e-3, atol=1e-9)
        np.testing.assert_allclose(rec[k], jrec[k], err_msg=k, **tol)
    [h] = sup_runs["history"]
    assert h["epoch"] == 0 and h["step"] == 2 and h["drop_percent"] == 20.0
    ck = ckpoints.load_full(os.path.join(prun, "ckpoints", "last.ckpt"))
    jck = jax_load_full(os.path.join(jrun, "ckpoints", "last.ckpt"))
    assert set(ck) == set(jck) == {"model_1", "epoch"} and ck["epoch"] == int(jck["epoch"]) == 0
    for k, t in ck["model_1"].items():
        assert torch.equal(t, sup_runs["state"].model.state_dict()[k]), k


@pytest.mark.parametrize("name", SUP_CONFIGS)
def test_shipped_sup_configs_through_the_cli(name, synthetic_dataset, tmp_path, capsys):
    cfg = _drv_cfg(name, synthetic_dataset, str(tmp_path / "runs"))
    cfg["wandb_logging"] = False
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    train_cli.main(["--config_path", str(path), "--max_steps_per_epoch", "1", "--device", "cpu"])
    assert "[Epoch0] " in capsys.readouterr().out
    [run] = os.listdir(tmp_path / "runs")
    assert run == f"{cfg['project_name']}_sup_0"
    ck = ckpoints.load_full(str(tmp_path / "runs" / run / "ckpoints" / "last.ckpt"))
    assert set(ck) == {"model_1", "epoch"}
    if name in DATA_VARIANTS:
        shutil.rmtree(tmp_path / "runs")
        return
    # the run's last.ckpt serves and is swept by the test CLI
    last = str(tmp_path / "runs" / run / "ckpoints" / "last.ckpt")
    pred = Predictor.from_checkpoint(Config(cfg), last, device="cpu", batch_size=2, half=False)
    labels = pred(np.zeros((2, HW, HW, 3), np.uint8))
    assert labels.shape == (2, HW, HW) and int(labels.max()) < 3
    cfg["test"].update(data_dir=synthetic_dataset, weights=os.path.dirname(last),
                       save_dir=str(tmp_path / "test"))
    best_path, best = test_cli.test(Config(cfg), save_img=False, device="cpu")
    assert best_path.endswith(".ckpt") and 0.0 <= best["test_miou"] <= 1.0
    shutil.rmtree(tmp_path / "runs")


def test_normalized_and_obia_datasets(synthetic_dataset, tmp_path):
    cfg = _drv_cfg("CWFID_Unet", synthetic_dataset, str(tmp_path / "runs"), dataset="normalized",
                   norm_mean=0.5, norm_std=0.25)
    cfg["wandb_logging"] = False
    history = []
    supervised.train(Config(cfg), max_steps_per_epoch=1, device="cpu", history=history)
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    # "obia" mixes the OBIA pseudo-targets of train/obia/ with the targets
    # (fcn32s on obia_CWFID.json itself: tests/test_torch_fcn.py)
    root = tmp_path / "obia_tree"
    shutil.copytree(synthetic_dataset, root)
    train_dir = root / "train"
    unlabelled = sorted(set(os.listdir(train_dir / "input"))
                        - set(os.listdir(train_dir / "target")))
    (train_dir / "obia").mkdir()
    for name in unlabelled:
        shutil.copy(train_dir / "target" / sorted(os.listdir(train_dir / "target"))[0],
                    train_dir / "obia" / name)
    cfg = _drv_cfg("CWFID_Unet", str(root), str(tmp_path / "runs_obia"), dataset="obia")
    cfg["wandb_logging"] = False
    history = []
    supervised.train(Config(cfg), max_steps_per_epoch=1, device="cpu", history=history)
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    ds = OBIADataset(str(train_dir), batch_size=2, resize=HW)
    n = len(os.listdir(train_dir / "target")) + len(unlabelled)
    assert len(ds) == n + n % 2 and os.path.basename(os.path.dirname(ds.target_files[0])) == "obia"


def test_sup_entry_points_need_the_card(synthetic_dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = _drv_cfg("CWFID_Unet", synthetic_dataset, str(tmp_path / "runs"))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    for call in (lambda: supervised.train(Config(copy.deepcopy(cfg))),
                 lambda: supervised.create_state(cfg["model"], lambda s: 1.0),
                 lambda: train_cli.main(["--config_path", str(path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not os.path.exists(tmp_path / "runs")
