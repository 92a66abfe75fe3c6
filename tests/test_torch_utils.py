"""Port parity: the host-side utilities, on the CPU.

  * ``data/sampling.py``: ``sampling`` and ``sample_dataset`` give the JAX
    package's file lists and tree for the same seed (exactly);
  * ``losses``: ``compute_class_weight`` with 255s present equals JAX's
    (which drops them, as ``jnp.bincount(length=n)`` does) within 1e-7;
    ``make_loss_as_func`` for each name equals JAX's on one input within
    1e-6 relative;
  * ``utils/debug.py``: ``check_finite`` gives JAX's paths for a NaN and
    an Inf leaf; ``finite_or_raise`` raises ``FloatingPointError``;
    ``enable_nan_debug`` puts anomaly mode back on exit;
  * ``utils/profiling.py``: ``StepMeter``'s summary follows JAX's
    arithmetic on injected times (exactly); ``trace`` writes a trace file
    on the CPU; the train CLI's ``--trace`` parses and writes one;
  * ``utils/processing.py::detach_numpy``.
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vq_seg_tpu.data import sampling as jsampling
from vq_seg_tpu.losses import compute_class_weight as jax_class_weight
from vq_seg_tpu.losses import make_loss_as_func as jax_loss_func
from vq_seg_tpu.utils import debug as jdebug
from vq_seg_tpu.utils import profiling as jprofiling
from vq_seg_tpu_torch import losses
from vq_seg_tpu_torch import train as train_cli
from vq_seg_tpu_torch.data import sampling
from vq_seg_tpu_torch.utils import debug, profiling
from vq_seg_tpu_torch.utils.processing import detach_numpy

torch.set_num_threads(1)


def _tree(base):
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, files in os.walk(base) for f in files)


@pytest.fixture(scope="module")
def full_tree(tmp_path_factory):
    """A fully labelled source tree: 12 images, two of them with an
    augmented sibling sharing the stem, and CWFID-style names."""
    root = tmp_path_factory.mktemp("full")
    rng = np.random.default_rng(3)
    for sub in ("train/input", "train/target", "test/input", "test/target"):
        (root / sub).mkdir(parents=True)
    names = [f"{i:03d}_image.png" for i in range(12)] + ["000_image_aug.png", "005_image_aug.png"]
    for name in names:
        Image.fromarray(rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)).save(
            root / "train" / "input" / name)
        Image.fromarray(rng.choice([0, 128, 255], size=(8, 8)).astype(np.uint8), "L").save(
            root / "train" / "target" / name)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(root / "test" / "input" / "t.png")
    return str(root)


@pytest.mark.parametrize("percent,seed", [(50, 0), (25, 7), (30, None)])
def test_sampling_builds_jax_tree(full_tree, tmp_path, percent, seed):
    if seed is None:  # no seed: both draw from the global generator where it stands
        import random
        random.seed(11)
    got = sampling.sampling(full_tree, str(tmp_path / "port"), total=12, percent=percent,
                            pattern="*_image.png", seed=seed)
    if seed is None:
        import random
        random.seed(11)
    want = jsampling.sampling(full_tree, str(tmp_path / "jax"), total=12, percent=percent,
                              pattern="*_image.png", seed=seed)
    assert os.path.basename(got) == os.path.basename(want) == f"percent_{percent}"
    assert _tree(got) == _tree(want)
    targets = os.listdir(os.path.join(got, "train", "target"))
    assert len(targets) >= int(12 * percent / 100)
    assert len(os.listdir(os.path.join(got, "train", "input"))) == 14


def test_sample_dataset_and_cli(full_tree, tmp_path):
    assert sampling.DATASET_PATTERNS == jsampling.DATASET_PATTERNS
    got = sampling.sample_dataset("CWFID", full_tree, str(tmp_path / "port"), 20, seed=3)
    want = jsampling.sample_dataset("CWFID", full_tree, str(tmp_path / "jax"), 20, seed=3)
    assert _tree(got) == _tree(want)
    sampling.main(["--dataset", "CWFID", "--data_root", full_tree, "--save_root",
                   str(tmp_path / "cli"), "--percent", "20", "--seed", "3"])
    assert _tree(str(tmp_path / "cli" / "percent_20.0")) == _tree(want)


def test_compute_class_weight_drops_the_ignore_label():
    rng = np.random.default_rng(0)
    y = rng.choice([0, 1, 2, 255], size=(2, 16, 16), p=[0.5, 0.2, 0.1, 0.2]).astype(np.int32)
    got = losses.compute_class_weight(3, torch.from_numpy(y).long())
    want = np.asarray(jax_class_weight(3, jnp.asarray(y)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    assert got.shape == (3,)
    small = np.array([0, 1, 2, 255, 2])
    np.testing.assert_allclose(losses.compute_class_weight(3, torch.from_numpy(small)).numpy(),
                               np.asarray(jax_class_weight(3, jnp.asarray(small))), atol=1e-7)


@pytest.mark.parametrize("name", ["cross_entropy", "dice_loss", "focal_loss", "nll_loss"])
def test_make_loss_as_func(name):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    if name == "nll_loss":
        logits = np.log(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    target = rng.integers(0, 3, size=(2, 8, 8)).astype(np.int32)
    got = losses.make_loss_as_func(name)(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                         torch.from_numpy(target).long())
    want = float(jax_loss_func(name)(jnp.asarray(logits), jnp.asarray(target)))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    assert set(losses.loss_func_dict) == {"cross_entropy", "dice_loss", "focal_loss", "nll_loss"}


def test_check_finite_paths_match_jax():
    good = np.ones((2, 2), np.float32)
    tree = {"b": {"w": good.copy(), "n": np.array([1.0, np.nan], np.float32)},
            "a": [good.copy(), np.array([np.inf], np.float32), np.arange(3)],
            "c": 2.0, "d": np.array([np.nan, np.inf], np.float64)}
    want = jdebug.check_finite(tree)
    assert want == [("a/1", "Inf"), ("b/n", "NaN"), ("d", "NaN")]
    assert debug.check_finite(tree) == want
    as_tensors = {"b": {"w": torch.from_numpy(good), "n": torch.tensor([1.0, float("nan")])},
                  "a": [torch.from_numpy(good), torch.tensor([float("inf")]), torch.arange(3)],
                  "c": 2.0, "d": torch.tensor([float("nan"), float("inf")], dtype=torch.float64)}
    assert debug.check_finite(as_tensors) == want
    assert debug.check_finite({"ok": torch.zeros(3), "step": 4}) == []
    # an optimizer's state_dict: integer keys, nested per-parameter state
    p = torch.nn.Parameter(torch.ones(2))
    opt = torch.optim.Adam([p])
    p.grad = torch.tensor([1.0, float("nan")])
    opt.step()
    assert debug.check_finite(opt.state_dict()) == [("state/0/exp_avg", "NaN"),
                                                    ("state/0/exp_avg_sq", "NaN")]
    with pytest.raises(FloatingPointError, match="a/1: Inf"):
        debug.finite_or_raise(tree, "tree")
    debug.finite_or_raise({"loss": torch.tensor(1.0)})


def test_enable_nan_debug_restores_the_mode():
    assert not torch.is_anomaly_enabled()
    with debug.enable_nan_debug():
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0.0).sum().backward()  # 0 * inf in sqrt's backward
    assert not torch.is_anomaly_enabled()


def test_step_meter_follows_jax():
    port, ref = profiling.StepMeter(8, smoothing=0.8), jprofiling.StepMeter(8, smoothing=0.8)
    for meter, module in ((port, profiling), (ref, jprofiling)):
        clock = iter([10.0, 10.5, 11.5, 11.75, 13.0])
        with mock.patch.object(module.time, "perf_counter", lambda: next(clock)):
            meter.start()
            for _ in range(4):
                meter.tick()
    assert port.summary() == ref.summary()
    assert port.summary()["steps"] == 4 and port.summary()["sec_per_step"] == 0.75
    assert port.images_per_sec == ref.images_per_sec > 0
    assert profiling.StepMeter(4).summary() == jprofiling.StepMeter(4).summary()


def test_trace_writes_a_file_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("region_of_interest"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    [name] = os.listdir(tmp_path / "tr")
    assert name.endswith(".pt.trace.json")
    assert "region_of_interest" in (tmp_path / "tr" / name).read_text()


def test_train_cli_trace_flag(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(train_cli, "load_config", lambda path: {"mode": "cps"})
    from vq_seg_tpu_torch import training
    monkeypatch.setattr(training, "train", lambda cfg, **kw: seen.append(kw) or torch.ones(3).sum())
    train_cli.main(["--config_path", "x.json", "--trace", str(tmp_path / "tr"), "--device", "cpu"])
    assert seen == [{"max_steps_per_epoch": None, "device": "cpu"}]
    assert [n for n in os.listdir(tmp_path / "tr") if n.endswith(".pt.trace.json")]


def test_detach_numpy():
    t = torch.arange(6.0, requires_grad=True).reshape(2, 3) * 2
    out = detach_numpy(t)
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    np.testing.assert_array_equal(out, np.arange(6.0).reshape(2, 3) * 2)
