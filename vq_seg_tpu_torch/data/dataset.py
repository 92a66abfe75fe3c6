"""Datasets and the batch loader, counterpart of the JAX package's
``data/dataset.py`` (``BaseDataset``, ``NormalizedDataset``,
``FolderDataset``, ``SalientDataset``, ``OBIADataset``, ``Loader``).

Items are host numpy, as in the JAX package: ``img`` HWC float32 in [0, 1]
(torchvision ``to_tensor`` values) and ``target`` the raw uint8 mask
pixels (class mapping happens on the device through ``img_to_label``).
Decoding takes the native C path (``fastimg``) and then PIL; where neither
is available it raises.

``Loader`` yields whole batches from a background thread.  With
``device=None`` a batch is host numpy, NHWC, as the JAX package's; with a
device, ``img`` becomes an (N, 3, H, W) float32 tensor and ``target`` an
(N, H, W) uint8 tensor on it.  On a CUDA device the worker thread pins
each batch and copies it with ``non_blocking=True`` on a side stream; the
consumer's stream waits on the copy's event, and each tensor is
``record_stream``-ed to the consumer's stream so that the caching
allocator does not reuse its memory while the step still reads it.

Reference semantics kept (reference data/dataset.py:15-62):
  * layout ``{data_dir}/input/*.png`` + ``{data_dir}/target/*.png``;
  * split "labelled" -> the files in target/, "unlabelled" -> input/ minus
    target/;
  * the file list padded to a multiple of batch_size by tiling;
  * bilinear resize for images, nearest for masks;
  * items are dicts {filename, img, target?}.
"""
from __future__ import annotations

import os
import queue
from glob import glob
import threading
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from . import fastimg


def _norm_resize(resize):
    if isinstance(resize, int):
        return (resize, resize)
    if isinstance(resize, (tuple, list)):
        return tuple(resize)
    if resize is None:
        return None
    raise ValueError(f"It's invalid type of resize {type(resize)}")


def _pad_to_batch(files: list, batch_size: Optional[int]) -> list:
    """``files`` tiled up to a multiple of ``batch_size`` (a single wrap
    would leave the list short when the pad exceeds the file count)."""
    if batch_size is None or len(files) % batch_size == 0:
        return files
    pad = batch_size - len(files) % batch_size
    return files + (files * -(-pad // len(files)))[:pad]


def _load_pair_pil(img_path, target_path, resize, target_resize):
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"cannot decode {img_path}: the native decoder (data/_fastimg.c, needs a C "
            "compiler, libpng and libdeflate) is unavailable and PIL is not installed")
    img = Image.open(img_path).convert("RGB")
    target = Image.open(target_path).convert("L") if target_path else None
    if resize is not None:
        img = img.resize(resize, resample=Image.BILINEAR)
        if target_resize and target is not None:
            target = target.resize(resize, resample=Image.NEAREST)
    img_np = np.asarray(img, dtype=np.float32) / 255.0  # HWC, [0, 1]
    tgt_np = np.asarray(target, dtype=np.uint8) if target is not None else None
    return img_np, tgt_np


def _load_pair(img_path, target_path, resize, target_resize):
    # the native path: one GIL-free C call per file, <= 1/255 from PIL's
    # bilinear image, masks bit-exact
    img_np = fastimg.load_rgb_f32(img_path, resize)
    if img_np is not None:
        tgt_np = None
        if target_path:
            tgt_np = fastimg.load_gray_u8(target_path, resize if target_resize else None)
        if tgt_np is not None or not target_path:
            return img_np, tgt_np
    return _load_pair_pil(img_path, target_path, resize, target_resize)


class BaseDataset:
    """(reference data/dataset.py:15-62)."""

    def __init__(self, data_dir: str, split: str, batch_size: Optional[int] = None,
                 resize=None, target_resize: bool = True):
        self.resize = _norm_resize(resize)
        self.img_dir = os.path.join(data_dir, "input")
        self.target_resize = target_resize
        if split == "labelled":
            self.filenames = sorted(os.listdir(os.path.join(data_dir, "target")))
            self.target_dir = os.path.join(data_dir, "target")
        elif split == "unlabelled":
            self.filenames = sorted(set(os.listdir(os.path.join(data_dir, "input")))
                                    - set(os.listdir(os.path.join(data_dir, "target"))))
            self.target_dir = None
        else:
            raise ValueError("split has to be labelled or unlabelled")
        self.filenames = _pad_to_batch(self.filenames, batch_size)

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, index):
        filename = self.filenames[index]
        tgt_path = os.path.join(self.target_dir, filename) if self.target_dir else None
        img, tgt = _load_pair(os.path.join(self.img_dir, filename), tgt_path, self.resize,
                              self.target_resize)
        out = {"filename": filename, "img": img}
        if tgt is not None:
            out["target"] = tgt
        return out


class NormalizedDataset(BaseDataset):
    """Mean/std-normalised inputs (reference data/dataset.py:168-222).  The
    reference normalises, converts back to a uint8 image and rescales by
    255: the item is clip(round(normalise(img) * 255), 0, 255) / 255."""

    def __init__(self, data_dir: str, split: str, batch_size: Optional[int] = None,
                 resize=None, target_resize: bool = True, mean=0.5, std=0.5):
        super().__init__(data_dir, split, batch_size, resize, target_resize)
        self.mean = mean
        self.std = std

    def __getitem__(self, index):
        out = super().__getitem__(index)
        img = (out["img"] - self.mean) / self.std
        out["img"] = (np.clip(np.round(img * 255.0), 0, 255) / 255.0).astype(np.float32)
        return out


class FolderDataset:
    """The ``*.png`` images of one folder, sorted, without targets (the
    ``selfsup`` trainer's VQ-VAE pretraining): items ``{filename, img}``,
    bilinearly resized; no padding to a batch multiple."""

    def __init__(self, data_dir: str, resize):
        self.images = sorted(glob(os.path.join(data_dir, "*.png")))
        self.resize = _norm_resize(resize)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        img, _ = _load_pair(self.images[index], None, self.resize, False)
        return {"filename": os.path.basename(self.images[index]), "img": img}


class SalientDataset(BaseDataset):
    """``BaseDataset`` items with ``salient_map``: the gray PNG
    ``{salient_dir}/{filename}`` NEAREST-resized to ``resize``, as float32
    in [0, 1] (reference data/dataset.py:80-127)."""

    def __init__(self, data_dir: str, salient_dir: str, split: str, resize=None,
                 target_resize: bool = True):
        super().__init__(data_dir, split, None, resize, target_resize)
        self.salient_dir = salient_dir

    def __getitem__(self, index):
        out = super().__getitem__(index)
        path = os.path.join(self.salient_dir, out["filename"])
        sal = fastimg.load_gray_u8(path, self.resize)
        if sal is None:
            from PIL import Image

            im = Image.open(path).convert("L")
            if self.resize is not None:
                im = im.resize(self.resize, resample=Image.NEAREST)
            sal = np.asarray(im, dtype=np.uint8)
        out["salient_map"] = sal.astype(np.float32) / 255.0
        return out


class OBIADataset:
    """True targets mixed with OBIA pseudo-targets (reference
    data/dataset.py:130-165): ``target/*.png`` and ``obia/*.png`` sorted
    into one list by full path (so ``obia/`` comes first), padded to a
    multiple of ``batch_size`` by repetition; each item's input is
    ``input/{filename}``.  Items ``{filename, img, target}``."""

    def __init__(self, data_dir: str, batch_size: Optional[int] = None, resize=None,
                 target_resize: bool = True):
        self.resize = _norm_resize(resize)
        self.img_dir = os.path.join(data_dir, "input")
        self.target_resize = target_resize
        self.target_files = _pad_to_batch(
            sorted(glob(os.path.join(data_dir, "target", "*.png"))
                   + glob(os.path.join(data_dir, "obia", "*.png"))), batch_size)

    def __len__(self):
        return len(self.target_files)

    def __getitem__(self, index):
        filename = os.path.basename(self.target_files[index])
        img, tgt = _load_pair(os.path.join(self.img_dir, filename), self.target_files[index],
                              self.resize, self.target_resize)
        return {"filename": filename, "img": img, "target": tgt}


class Loader:
    """Batched iterator with shuffle, a decoded-item RAM cache, a decode
    thread pool and a background thread that builds batch n+1 (and copies
    it to ``device``) while batch n is in use.

    ``shuffle`` draws ``np.random.default_rng(seed).shuffle(order)`` once per
    epoch, so a seed gives the JAX package's batch order.  ``workers`` > 0
    decodes the items of a batch in a thread pool.  The cache keeps decoded
    items after their first use unless the whole set would exceed
    ``cache_budget_bytes`` (estimated from the first item).  An error in
    the background thread is raised in the consumer.  ``device`` is "cuda"
    unless the caller passes "cpu", or None for host numpy batches.
    ``shard=(i, n)``: ``batch_size`` is the global batch, and this loader
    decodes and yields only the rows [i*b, (i+1)*b) of each global batch, b
    = batch_size / n, from the same seeded order on every rank: the data
    rank i's shard, as ``parallel.shard_batch_fn`` lays a batch out.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 device="cuda", prefetch: int = 2, workers: int = 0,
                 cache_budget_bytes: int = 4 << 30, shard: Optional[tuple] = None):
        self.dataset = dataset
        self.shard = shard
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device) if device is not None else None
        self.prefetch = prefetch
        self.workers = workers
        self._cache: Optional[dict] = {}
        self._cache_budget = cache_budget_bytes
        self._stream = None

    def _get_item(self, i: int):
        if self._cache is None:
            return self.dataset[i]
        hit = self._cache.get(i)
        if hit is not None:
            return hit
        item = self.dataset[i]
        nbytes = sum(v.nbytes for v in item.values() if hasattr(v, "nbytes"))
        if nbytes * len(self.dataset) > self._cache_budget:
            self._cache = None  # too big: decode every epoch
            return item
        self._cache[i] = item
        return item

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        pool = None
        if self.workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=self.workers)
        try:
            for b in range(len(self)):
                idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                if self.shard is not None:
                    i, n = self.shard
                    if len(idx) % n:
                        raise ValueError(f"batch {b} of {len(idx)} items does not divide over "
                                         f"{n} data ranks")
                    per = len(idx) // n
                    idx = idx[i * per:(i + 1) * per]
                if pool is not None:
                    items = list(pool.map(self._get_item, (int(i) for i in idx)))
                else:
                    items = [self._get_item(int(i)) for i in idx]
                batch = {"filename": [it["filename"] for it in items]}
                for key in items[0]:
                    if key != "filename":
                        batch[key] = np.stack([it[key] for it in items], axis=0)
                yield batch
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def _to_device(self, batch):
        """Host batch -> tensors on ``self.device``; ``img`` to NCHW.
        Returns (batch, event to wait on or None)."""
        out = {"filename": batch["filename"]}
        if self.device.type != "cuda":
            for k, v in batch.items():
                if k != "filename":
                    t = torch.from_numpy(v)
                    out[k] = t.permute(0, 3, 1, 2).contiguous() if k == "img" else t
            return out, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            for k, v in batch.items():
                if k != "filename":
                    t = torch.from_numpy(v).pin_memory().to(self.device, non_blocking=True)
                    out[k] = t.permute(0, 3, 1, 2).contiguous() if k == "img" else t
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            # decode/IO errors go to the consumer and are raised there: a
            # clean end would silently truncate the epoch
            batches = self._batches()
            try:
                for batch in batches:
                    item = self._to_device(batch) if self.device is not None else (batch, None)
                    if not put(item):
                        return
                put(done)
            except BaseException as e:  # noqa: BLE001
                put(e)
            finally:
                batches.close()

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                batch, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for v in batch.values():
                        if isinstance(v, torch.Tensor):
                            v.record_stream(stream)
                yield batch
        finally:
            # a consumer that stops early (a capped epoch) ends the thread
            stop.set()
