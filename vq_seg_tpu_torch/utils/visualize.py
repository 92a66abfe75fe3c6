"""Visualization helpers (reference utils/visualize.py), numpy only: the
port's copy of the JAX package's ``utils/visualize.py``.

Colours: background black, weed blue, crop red (visualize.py:59); the
TP/FP detail map appends per-class FP colours gray/orange/yellow
(visualize.py:22-37).  Inputs are channel-last (N, H, W, C) float arrays in
[0, 1]; a caller with NCHW tensors moves the channel axis first.
``save_img`` writes PNG with ``write_png``, a small encoder on the
standard library's ``zlib``, so nothing here needs PIL.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional

import numpy as np

DEFAULT_COLORMAP = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
DETAIL_COLORMAP = np.array([
    [0, 0, 0], [0, 0, 1], [1, 0, 0],                                               # TP: bg/weed/crop
    [0.5, 0.5, 0.5], [230 / 255, 145 / 255, 56 / 255], [1, 217 / 255, 102 / 255],  # FP
])


def gray_to_rgb(img: np.ndarray) -> np.ndarray:
    """(N,H,W) or (N,H,W,1) -> (N,H,W,3) (visualize.py:8-15)."""
    if img.ndim == 3:
        return np.stack([img] * 3, axis=-1)
    if img.ndim == 4:
        return np.concatenate([img] * 3, axis=-1)
    raise NotImplementedError("implemented for 3- and 4-d arrays only")


def pred_to_colormap(pred: np.ndarray, colormap: np.ndarray = DEFAULT_COLORMAP):
    """(N,H,W,C) scores -> (N,H,W,3) colours (visualize.py:17-20)."""
    return colormap[np.argmax(pred, axis=-1)]


def pred_to_detailed_colormap(pred: np.ndarray, target: np.ndarray,
                              colormap: np.ndarray = DETAIL_COLORMAP):
    """TP/FP colouring (visualize.py:22-37): false positives of class k get
    colour k + num_classes."""
    labels = np.unique(target).tolist()
    num_classes = len(labels)
    pred_label = np.argmax(pred, axis=-1)
    for label in labels:
        pred_label[(pred_label == label) & (target != label)] = label + num_classes
    if num_classes != 3:
        raise NotImplementedError
    return DETAIL_COLORMAP[pred_label]


def target_to_colormap(target: np.ndarray, colormap: np.ndarray = DEFAULT_COLORMAP):
    return colormap[target]


def batch_to_grid(array: np.ndarray) -> np.ndarray:
    """(N,H,W,C) -> (H, N*W, C) horizontal strip (visualize.py:46-49)."""
    return np.concatenate(list(array), axis=1)


def mix_input_pred(inp: np.ndarray, pred: np.ndarray, alpha: float = 0.4):
    return np.clip(inp * (1 - alpha) + pred * alpha, 0, 1)


def _resize_half(img: np.ndarray, factor: Optional[float]):
    if factor is None:
        return img
    step = int(round(1 / factor))
    return img[::step, ::step]


def make_example_img(l_input, target, pred, ul_input, ul_pred,
                     colormap: np.ndarray = DEFAULT_COLORMAP, resize_factor=0.5):
    """Train panel (visualize.py:59-76): labeled strip [input|target|pred],
    a separator, then the unlabeled input/pred alpha blend."""
    l_cat = np.concatenate((
        batch_to_grid(l_input),
        batch_to_grid(target_to_colormap(target, colormap)),
        batch_to_grid(pred_to_colormap(pred, colormap)),
    ), axis=1)
    if ul_input is None and ul_pred is None:
        return _resize_half(l_cat, resize_factor)
    h, _, c = l_cat.shape
    ul_mix = mix_input_pred(batch_to_grid(ul_input),
                            batch_to_grid(pred_to_colormap(ul_pred, colormap)))
    interval = np.ones((h, 20, c))
    return _resize_half(np.concatenate((l_cat, interval, ul_mix), axis=1), resize_factor)


def make_selfsup_example(target, recon):
    """[target|recon] strip for VQ-VAE pretraining (visualize.py:170-173)."""
    return batch_to_grid(np.concatenate((target, recon), axis=2))


def make_test_img(inp, pred, target, colormap: np.ndarray = DEFAULT_COLORMAP):
    """(visualize.py:176-186): ([input|target|pred], the input/pred blend)."""
    p = batch_to_grid(pred_to_colormap(pred, colormap))
    i = batch_to_grid(inp)
    t = batch_to_grid(target_to_colormap(target, colormap))
    return np.concatenate((i, t, p), axis=1), mix_input_pred(i, p)


def make_test_detailed_img(inp, pred, target, colormap: np.ndarray = DEFAULT_COLORMAP):
    """TP/FP variant (visualize.py:188-194)."""
    p = batch_to_grid(pred_to_detailed_colormap(pred, target))
    i = batch_to_grid(inp)
    t = batch_to_grid(target_to_colormap(target, colormap))
    return np.concatenate((i, t, p), axis=1), mix_input_pred(i, p)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray, level: int = 6):
    """Write an (H, W) gray or (H, W, 3) RGB uint8 array as an 8-bit,
    non-interlaced PNG: filter type 0 on every row, one zlib stream at
    ``level``."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8, got {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    color = 0 if arr.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))


def save_img(img_dir: str, filename: str, img: np.ndarray):
    """A float image in [0, 1] (values outside are clipped) as uint8 PNG."""
    write_png(os.path.join(img_dir, filename), (np.clip(img, 0, 1) * 255).astype(np.uint8))


def save_img_list(img_dir: str, filename_list: List[str], img_list: List[np.ndarray]):
    for img, filename in zip(img_list, filename_list):
        save_img(img_dir, filename, img)
