"""Port parity: the data path (``data/dataset.py``, ``data/fastimg.py``) and
the numpy visualisation helpers against the JAX package, on a PNG tree
made as ``tests/conftest.py::synthetic_dataset`` makes it (40x40 files, so
the resize to 64 runs).

  * ``BaseDataset`` items equal JAX's through each decode path (the native
    C library, then PIL): images within 1/255, masks bit-exact.  Threads
    that load the native library while it builds all get it.
  * The labelled/unlabelled split and the tiling pad equal JAX's.
  * ``Loader`` batch order for seeds 0 and 1 over two epochs equals JAX's
    exactly; its CPU tensors are the numpy batch in NCHW.
  * A decode error is raised in the consumer; a consumer that stops early
    ends the loader's thread.
  * ``write_png``/``save_img`` round-trip through PIL bit-exact, and
    ``make_example_img`` equals JAX's.
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import os
import threading
import time

import numpy as np
import pytest
import torch

from vq_seg_tpu.data import dataset as jds
from vq_seg_tpu.data import fastimg as jfastimg
from vq_seg_tpu.utils import visualize as jviz
from vq_seg_tpu_torch.data import BaseDataset, Loader
from vq_seg_tpu_torch.data import dataset as tds
from vq_seg_tpu_torch.data import fastimg
from vq_seg_tpu_torch.utils import visualize

torch.set_num_threads(1)

Image = pytest.importorskip("PIL.Image")


def _use_pil(monkeypatch):
    """Both packages skip their native decoder."""
    for mod in (fastimg, jfastimg):
        monkeypatch.setattr(mod, "load_rgb_f32", lambda *a, **k: None)
        monkeypatch.setattr(mod, "load_gray_u8", lambda *a, **k: None)


@pytest.mark.parametrize("path", ["native", "pil"])
@pytest.mark.parametrize("split,resize,target_resize", [
    ("labelled", 64, True), ("labelled", 32, False), ("unlabelled", 64, True),
    ("labelled", None, True)])
def test_items_equal_jax(synthetic_dataset, monkeypatch, path, split, resize, target_resize):
    if path == "native":
        assert fastimg.load() is not None, "the native decoder did not build here"
    else:
        _use_pil(monkeypatch)
    d = os.path.join(synthetic_dataset, "train")
    ours = BaseDataset(d, split, batch_size=2, resize=resize, target_resize=target_resize)
    ref = jds.BaseDataset(d, split, batch_size=2, resize=resize, target_resize=target_resize)
    assert ours.filenames == ref.filenames
    hw = (40, 40) if resize is None else (resize, resize)
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys() and a["filename"] == b["filename"]
        assert a["img"].dtype == np.float32 and a["img"].shape == hw + (3,)
        assert np.abs(a["img"] - b["img"]).max() <= 1.0 / 255.0
        if split == "labelled":
            assert a["target"].dtype == np.uint8
            assert a["target"].shape == (hw if target_resize else (40, 40))
            np.testing.assert_array_equal(a["target"], b["target"])


def test_decoder_load_is_thread_safe(monkeypatch):
    """Decode threads that ask for the native library while another one
    builds it wait for it: none gets None and decodes its item through PIL,
    which differs by up to 2/255 (a loader's first batch would then differ
    from run to run with the threads' timing)."""
    real_build = fastimg._build
    building = threading.Event()

    def slow_build():
        building.set()
        time.sleep(0.2)
        return real_build()

    monkeypatch.setattr(fastimg, "_lib", None)
    monkeypatch.setattr(fastimg, "_tried", False)
    monkeypatch.setattr(fastimg, "_build", slow_build)
    first = {}
    t = threading.Thread(target=lambda: first.setdefault("lib", fastimg.load()))
    t.start()
    assert building.wait(5)
    rest = []
    waiters = [threading.Thread(target=lambda: rest.append(fastimg.load())) for _ in range(3)]
    for w in waiters:
        w.start()
    for w in [t] + waiters:
        w.join(30)
    assert first["lib"] is not None
    assert len(rest) == 3 and all(lib is first["lib"] for lib in rest)


def test_native_decoder_matches_pil(synthetic_dataset):
    """The two paths of the port: masks bit-exact, images within the 2/255
    that the JAX package's own native-vs-PIL test allows."""
    assert fastimg.load() is not None
    d = os.path.join(synthetic_dataset, "train")
    img_p, tgt_p = os.path.join(d, "input", "im000.png"), os.path.join(d, "target", "im000.png")
    for resize in ((64, 64), (24, 56), None):
        ni, nt = tds._load_pair(img_p, tgt_p, resize, True)
        pi, pt = tds._load_pair_pil(img_p, tgt_p, resize, True)
        assert np.abs(ni - pi).max() <= 2.0 / 255.0 + 1e-6
        np.testing.assert_array_equal(nt, pt)


@pytest.mark.parametrize("batch_size", [1, 2, 4, 7])
def test_split_and_padding_rules(synthetic_dataset, batch_size):
    d = os.path.join(synthetic_dataset, "train")
    lab = BaseDataset(d, "labelled", batch_size=batch_size)
    unlab = BaseDataset(d, "unlabelled", batch_size=batch_size)
    targets = sorted(os.listdir(os.path.join(d, "target")))
    inputs = sorted(os.listdir(os.path.join(d, "input")))
    assert sorted(set(lab.filenames)) == targets
    assert sorted(set(unlab.filenames)) == sorted(set(inputs) - set(targets))
    for ds, n in ((lab, len(targets)), (unlab, len(inputs) - len(targets))):
        assert len(ds) % batch_size == 0
        # tiled: the sorted list repeated, cut at the padded length
        assert ds.filenames == (sorted(set(ds.filenames)) * len(ds))[:len(ds)]
        assert len(ds) == n if n % batch_size == 0 else len(ds) == n + batch_size - n % batch_size
    for split in ("labelled", "unlabelled"):
        assert (BaseDataset(d, split, batch_size=batch_size).filenames
                == jds.BaseDataset(d, split, batch_size=batch_size).filenames)
    with pytest.raises(ValueError):
        BaseDataset(d, "test")


@pytest.mark.parametrize("seed", [0, 1])
def test_loader_order_equals_jax(synthetic_dataset, seed):
    d = os.path.join(synthetic_dataset, "train")
    ds = BaseDataset(d, "labelled", batch_size=2, resize=64)
    ours = Loader(ds, 2, shuffle=True, seed=seed, device=None, workers=2)
    on_cpu = Loader(ds, 2, shuffle=True, seed=seed, device="cpu")
    ref = jds.Loader(jds.BaseDataset(d, "labelled", batch_size=2, resize=64), 2, shuffle=True,
                     seed=seed)
    assert len(ours) == len(ref) == 3
    for _ in range(2):  # epochs: one shuffle each
        got = list(ours)
        want = list(ref)
        tensors = list(on_cpu)
        assert [b["filename"] for b in got] == [b["filename"] for b in want]
        assert [b["filename"] for b in tensors] == [b["filename"] for b in want]
        for g, w, t in zip(got, want, tensors):
            assert np.abs(g["img"] - w["img"]).max() <= 1.0 / 255.0
            np.testing.assert_array_equal(g["target"], w["target"])
            assert t["img"].shape == (2, 3, 64, 64) and t["img"].dtype == torch.float32
            np.testing.assert_array_equal(t["img"].permute(0, 2, 3, 1).numpy(), g["img"])
            assert t["target"].dtype == torch.uint8
            np.testing.assert_array_equal(t["target"].numpy(), g["target"])


class _Counting:
    def __init__(self, ds):
        self.ds, self.calls = ds, []

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        self.calls.append(i)
        return self.ds[i]


def test_loader_caches_decoded_items(synthetic_dataset):
    ds = _Counting(BaseDataset(os.path.join(synthetic_dataset, "train"), "labelled",
                               batch_size=2, resize=64))
    loader = Loader(ds, 2, shuffle=True, device=None)
    list(loader)
    list(loader)
    assert sorted(ds.calls) == list(range(len(ds)))  # decoded once, then served from RAM
    small = Loader(ds, 2, device=None, cache_budget_bytes=1)
    list(small)
    list(small)
    assert len(ds.calls) == 3 * len(ds)  # over the budget: decoded every epoch


@pytest.mark.parametrize("workers,device", [(0, None), (2, "cpu")])
def test_decode_error_raises_in_the_consumer(synthetic_dataset, tmp_path, workers, device):
    d = tmp_path / "bad"
    (d / "input").mkdir(parents=True)
    (d / "target").mkdir()
    for i in range(4):
        src = os.path.join(synthetic_dataset, "train", "input", f"im00{i}.png")
        (d / "input" / f"im00{i}.png").write_bytes(open(src, "rb").read())
    (d / "input" / "im002.png").write_bytes(b"\x89PNG\r\n\x1a\nnot really a png")
    loader = Loader(BaseDataset(str(d), "unlabelled", batch_size=2), 2, device=device,
                    workers=workers)
    with pytest.raises(OSError):  # PIL's error on the corrupt file
        list(loader)


def test_early_stop_ends_the_thread(synthetic_dataset):
    ds = BaseDataset(os.path.join(synthetic_dataset, "train"), "labelled", batch_size=1)
    before = threading.active_count()
    it = iter(Loader(ds, 1, device="cpu", prefetch=1))
    next(it)
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_loader_default_device_is_the_card(synthetic_dataset):
    ds = BaseDataset(os.path.join(synthetic_dataset, "train"), "labelled", batch_size=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Loader(ds, 1)


@pytest.mark.parametrize("shape", [(13, 29, 3), (17, 11)])
def test_write_png_round_trips_through_pil(tmp_path, shape):
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / "a.png")
    visualize.write_png(p, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), arr)
    assert fastimg.load() is None or np.array_equal(
        fastimg.load_gray_u8(p) if arr.ndim == 2 else
        np.round(fastimg.load_rgb_f32(p) * 255).astype(np.uint8), arr)
    img = rng.uniform(-0.1, 1.1, (9, 7, 3))
    visualize.save_img(str(tmp_path), "b.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "b.png")),
                                  (np.clip(img, 0, 1) * 255).astype(np.uint8))


def test_example_and_detail_images_equal_jax():
    rng = np.random.default_rng(6)
    n, h, w = 2, 8, 12
    l_in, ul_in = rng.uniform(size=(n, h, w, 3)), rng.uniform(size=(n, h, w, 3))
    target = rng.integers(0, 3, (n, h, w))
    pred, ul_pred = rng.standard_normal((n, h, w, 3)), rng.standard_normal((n, h, w, 3))
    np.testing.assert_array_equal(visualize.make_example_img(l_in, target, pred, ul_in, ul_pred),
                                  jviz.make_example_img(l_in, target, pred, ul_in, ul_pred))
    np.testing.assert_array_equal(visualize.make_example_img(l_in, target, pred, None, None),
                                  jviz.make_example_img(l_in, target, pred, None, None))
    for ours, ref in zip(visualize.make_test_detailed_img(l_in, pred, target),
                         jviz.make_test_detailed_img(l_in, pred, target)):
        np.testing.assert_array_equal(ours, ref)
