"""Port parity: losses, metrics, label tools and LR schedules of the port
against the JAX package, f32 on the CPU.

The same numpy inputs, made from a seed, go through both: NHWC to the JAX
package, NCHW to the port.  Integers must be equal; floats within 1e-6
relative (1e-9 absolute where a value can be 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu import losses as jl
from vq_seg_tpu.losses import dice as jdice
from vq_seg_tpu.metrics import measurement as jm
from vq_seg_tpu.models.layers import resize_nearest as j_resize_nearest
from vq_seg_tpu.training import schedules as js
from vq_seg_tpu.utils import seg_tools as jst
from vq_seg_tpu_torch import losses as tl
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.metrics import measurement as tm
from vq_seg_tpu_torch.models.layers import resize_nearest
from vq_seg_tpu_torch.training import schedules as ts
from vq_seg_tpu_torch.utils import seg_tools as tst

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-9
N, H, W, C = 2, 12, 10, 3
WEIGHT = [0.2, 0.3, 0.5]


def _inputs(seed=0, c=C, ignore_share=0.2):
    """Logits (N, H, W, c) f32 and targets (N, H, W) int with about
    ``ignore_share`` of the pixels 255."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((N, H, W, c)) * 2).astype(np.float32)
    target = rng.integers(0, max(c, 2), size=(N, H, W)).astype(np.int32)
    target[rng.uniform(size=target.shape) < ignore_share] = 255
    return logits, target


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port, dtype=np.float64),
                               np.asarray(ref, dtype=np.float64), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ignore_index,weight,ignore_share", [
    (-100, None, 0.0), (255, None, 0.2), (255, WEIGHT, 0.2), (255, None, 1.0)],
    ids=["plain", "ignore", "ignore-weighted", "all-ignored"])
@pytest.mark.parametrize("kind", ["cross_entropy_loss", "nll_loss"])
def test_cross_entropy_and_nll(kind, ignore_index, weight, ignore_share):
    logits, target = _inputs(1, ignore_share=ignore_share)
    if kind == "nll_loss":  # NLL takes log-probabilities
        logits = np.asarray(torch.log_softmax(torch.from_numpy(logits), -1))
    jfn, tfn = getattr(jl, kind), getattr(tl, kind)
    ref = jfn(jnp.asarray(logits), jnp.asarray(target), ignore_index=ignore_index, weight=weight)
    out = tfn(_nchw(logits), torch.from_numpy(target).long(), ignore_index, weight)
    _close(out, ref)
    if ignore_share == 1.0:
        assert float(out) == 0.0


@pytest.mark.parametrize("num_classes,ignore_index,weight", [
    (3, None, None), (3, 255, None), (3, 255, WEIGHT), (1, None, None)],
    ids=["plain", "ignore-quirk", "ignore-weighted", "binary"])
def test_dice(num_classes, ignore_index, weight):
    logits, target = _inputs(2, c=num_classes, ignore_share=0.2 if ignore_index else 0.0)
    if num_classes == 1:
        target = np.minimum(target, 1)
    jt = jnp.asarray(target)
    tt = torch.from_numpy(target).long()
    _close(tl.dice_coefficient(_nchw(logits), tt, num_classes, ignore_index),
           jdice.dice_coefficient(jnp.asarray(logits), jt, num_classes, ignore_index))
    _close(tl.dice_loss(_nchw(logits), tt, num_classes, weight, ignore_index),
           jl.dice_loss(jnp.asarray(logits), jt, num_classes, weight, ignore_index))


@pytest.mark.parametrize("name", ["cross_entropy", "dice_loss", "nll_loss"])
def test_make_loss(name):
    logits, target = _inputs(3)
    ref = jl.make_loss(name, C, ignore_index=255, weight=WEIGHT)(jnp.asarray(logits),
                                                                 jnp.asarray(target))
    out = tl.make_loss(name, C, ignore_index=255, weight=WEIGHT)(_nchw(logits),
                                                                 torch.from_numpy(target).long())
    _close(out, ref)


@pytest.mark.parametrize("as_scores", [True, False], ids=["scores", "labels"])
def test_confusion_matrix_and_metrics(as_scores):
    logits, target = _inputs(4, ignore_share=0.0)
    target[0, 0, :3] = 255  # out-of-range bins are dropped by both
    pred_j = jnp.asarray(logits) if as_scores else jnp.argmax(jnp.asarray(logits), -1)
    pred_t = _nchw(logits) if as_scores else torch.from_numpy(np.argmax(logits, -1))
    tt = torch.from_numpy(target).long()
    conf_j = jm.confusion_matrix(pred_j, jnp.asarray(target), num_classes=C)
    conf_t = tm.confusion_matrix(pred_t, tt, C)
    assert conf_t.shape == (N, C, C) and conf_t.dtype == torch.float32
    np.testing.assert_array_equal(conf_t.numpy(), np.asarray(conf_j))
    for name in ("miou", "precision", "recall"):
        (mt, lt), (mj, lj) = getattr(tm, name)(conf_t), getattr(jm, name)(conf_j)
        _close(mt, mj)
        _close(lt, lj)
    _close(tm.f1score(tm.recall(conf_t)[0], tm.precision(conf_t)[0]),
           jm.f1score(jm.recall(conf_j)[0], jm.precision(conf_j)[0]))
    for ignore_idx in (None, 255):
        _close(tm.accuracy(pred_t, tt, ignore_idx),
               jm.accuracy(pred_j, jnp.asarray(target), ignore_idx))
    ref = jm.Measurement(C, ignore_idx=255)(np.asarray(pred_j), target)
    out = tm.Measurement(C, ignore_idx=255)(pred_t, tt)
    for a, b in zip(out, ref):
        _close(a, b)


def test_label_tools():
    rng = np.random.default_rng(5)
    mask = rng.choice(np.array([0, 128, 255, 7], np.uint8), size=(N, H, W))
    p2l = {"0": 0, "128": 1, "255": 2}
    lab = tst.img_to_label(torch.from_numpy(mask), p2l)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jst.img_to_label(jnp.asarray(mask), p2l)))
    labels = rng.integers(0, 4, size=(N, H, W))  # 3 is outside the classes: an all-eps row
    _close(tst.label_to_onehot(torch.from_numpy(labels), C),
           np.moveaxis(np.asarray(jst.label_to_onehot(jnp.asarray(labels), C)), -1, 1))
    _close(tst.onehot_1d(torch.from_numpy(labels), C),
           jst.onehot_1d(jnp.asarray(labels), C))
    logits, _ = _inputs(6)
    for th in (0.5, 0.7):
        np.testing.assert_array_equal(
            tst.score_mask(_nchw(logits), th).numpy(),
            np.moveaxis(np.asarray(jst.score_mask(jnp.asarray(logits), th)), -1, 1))
        pseudo = np.argmax(logits, -1)
        np.testing.assert_array_equal(
            tst.confidence_filtered_pseudo(_nchw(logits), torch.from_numpy(pseudo), th).numpy(),
            np.asarray(jst.confidence_filtered_pseudo(jnp.asarray(logits), jnp.asarray(pseudo), th)))


@pytest.mark.parametrize("size", [(6, 5), (24, 20), (7, 3), (12, 10)])
def test_resize_nearest_is_floor_indexed(size):
    labels = np.random.default_rng(7).integers(0, 3, size=(N, H, W)).astype(np.int32)
    out = resize_nearest(torch.from_numpy(labels), size)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_resize_nearest(jnp.asarray(labels), size)))
    iy = np.floor(np.arange(size[0]) * (H / size[0])).astype(int)
    np.testing.assert_array_equal(out.numpy()[:, :, 0], labels[:, iy, 0])


@pytest.mark.parametrize("sched", [
    {"name": "cosineannealing", "min_lr": 1e-7, "warmup_steps": 0},
    {"name": "cosineannealing", "min_lr": 1e-6, "warmup_steps": 5},
    {"name": "warmuppoly", "lr_power": 0.9, "warmup_epoch": 2},
    {"name": "poly", "power": 0.9},
    {"name": "multistep", "milestones": [3, 7]},
    {"name": "multistep"},
], ids=["cosine", "cosine-warmup-steps", "warmuppoly", "poly", "multistep", "multistep-default"])
def test_schedules_every_step(sched):
    steps_per_epoch, epochs = 8, 12
    cfg = Config({"learning_rate": 1e-4, "num_epochs": epochs, "lr_scheduler": sched})
    jfn, tfn = js.make_lr_schedule(cfg, steps_per_epoch), ts.make_lr_schedule(cfg, steps_per_epoch)
    steps = range(steps_per_epoch * epochs)  # 0 .. N-1; poly reaches 0 at N
    out = np.array([tfn(s) for s in steps])
    assert all(isinstance(tfn(s), float) for s in (0, 5))
    _close(out, np.array([float(jfn(s)) for s in steps]))


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        tl.make_loss("hinge", C)
    with pytest.raises(ValueError):
        ts.make_lr_schedule(Config({"learning_rate": 1.0, "num_epochs": 1,
                                    "lr_scheduler": {"name": "step"}}), 1)
