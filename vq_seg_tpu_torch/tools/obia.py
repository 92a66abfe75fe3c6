"""OBIA pseudo-labeling (reference deprecated/obia_pseudolabel.py), the
port's copy of the JAX package's ``tools/obia.py``.

Object-based image analysis: SLIC superpixels -> per-superpixel features
(RGB channel means + LBP texture histogram) -> a random forest trained on
the labeled subset's majority-vote superpixel labels -> per-superpixel
pseudo masks for unlabeled images.  LBP is numpy (no skimage), and the
forest is ``tools/forest.py``'s (no sklearn): CART with Gini, bootstrap
samples and sqrt(features) per split, as sklearn's default
``RandomForestClassifier``; its draws are its own, so its pseudo-labels
are not sklearn's bit for bit.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from .forest import RandomForest
from .slic import slic


def lbp_8(gray: np.ndarray) -> np.ndarray:
    """8-neighbour local binary pattern codes (H, W) uint8."""
    g = np.pad(gray, 1, mode="edge")
    c = g[1:-1, 1:-1]
    code = np.zeros_like(c, dtype=np.uint8)
    shifts = [(-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1)]
    for bit, (dy, dx) in enumerate(shifts):
        neigh = g[1 + dy:g.shape[0] - 1 + dy, 1 + dx:g.shape[1] - 1 + dx]
        code |= ((neigh >= c) << bit).astype(np.uint8)
    return code


def superpixel_features(image: np.ndarray, labels: np.ndarray, n_bins: int = 16):
    """(n_superpixels, 3 + n_bins) features: RGB means + LBP histogram."""
    n = labels.max() + 1
    flat = labels.ravel()
    counts = np.maximum(np.bincount(flat, minlength=n), 1)
    rgb_means = np.stack([
        np.bincount(flat, weights=image[..., c].ravel(), minlength=n) / counts
        for c in range(3)
    ], axis=1)
    gray = image.mean(-1)
    codes = lbp_8((gray * 255).astype(np.uint8)).ravel() // (256 // n_bins)
    hist = np.zeros((n, n_bins))
    np.add.at(hist, (flat, codes), 1.0)
    hist /= counts[:, None]
    return np.concatenate([rgb_means, hist], axis=1)


def majority_labels(mask: np.ndarray, labels: np.ndarray, num_classes: int = 3):
    """Per-superpixel majority class of a dense mask."""
    n = labels.max() + 1
    out = np.zeros(n, np.int64)
    votes = np.zeros((n, num_classes))
    np.add.at(votes, (labels.ravel(), mask.ravel().astype(np.int64)), 1.0)
    out = votes.argmax(axis=1)
    return out


class OBIAPseudoLabeler:
    """Train on (image, mask) pairs; predict dense pseudo-masks."""

    def __init__(self, n_segments: int = 200, num_classes: int = 3,
                 n_estimators: int = 100, seed: int = 0):
        self.n_segments = n_segments
        self.num_classes = num_classes
        self.clf = RandomForest(n_estimators=n_estimators, seed=seed)

    def fit(self, images: Sequence[np.ndarray], masks: Sequence[np.ndarray]):
        feats, labs = [], []
        for img, mask in zip(images, masks):
            sp = slic(img, self.n_segments)
            feats.append(superpixel_features(img, sp))
            labs.append(majority_labels(mask, sp, self.num_classes))
        self.clf.fit(np.concatenate(feats), np.concatenate(labs))
        return self

    def predict(self, image: np.ndarray) -> np.ndarray:
        sp = slic(image, self.n_segments)
        pred = self.clf.predict(superpixel_features(image, sp))
        return pred[sp]


def build_pseudo_labels(data_dir: str, out_dir: str, pixel_to_label: dict,
                        num_classes: int = 3, n_segments: int = 200):
    """Directory driver: train on {data_dir}/target pairs, write pseudo masks
    for unlabeled inputs into {out_dir} (reference obia_pseudolabel.py flow)."""
    from PIL import Image

    label_to_pixel = {v: int(k) for k, v in pixel_to_label.items()}
    tgt_dir = os.path.join(data_dir, "target")
    in_dir = os.path.join(data_dir, "input")
    labeled = sorted(os.listdir(tgt_dir))
    unlabeled = sorted(set(os.listdir(in_dir)) - set(labeled))
    lut = np.arange(256)
    for k, v in pixel_to_label.items():
        lut[int(k)] = v
    images, masks = [], []
    for fn in labeled:
        images.append(np.asarray(Image.open(os.path.join(in_dir, fn)).convert("RGB")) / 255.0)
        masks.append(lut[np.asarray(Image.open(os.path.join(tgt_dir, fn)).convert("L"))])
    labeler = OBIAPseudoLabeler(n_segments, num_classes).fit(images, masks)
    os.makedirs(out_dir, exist_ok=True)
    for fn in unlabeled:
        img = np.asarray(Image.open(os.path.join(in_dir, fn)).convert("RGB")) / 255.0
        pseudo = labeler.predict(img)
        px = np.vectorize(label_to_pixel.get)(pseudo).astype(np.uint8)
        Image.fromarray(px, mode="L").save(os.path.join(out_dir, fn))
    return labeler
