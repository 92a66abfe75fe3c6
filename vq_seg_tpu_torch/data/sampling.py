"""Offline semi-supervised split builder, counterpart of the JAX package's
``data/sampling.py`` (reference sampling.py:10-72).  Host-only.

Builds ``{save_root}/percent_{P}/train/{input,target}`` and ``test`` where
``target/`` holds a random P % subset of the labels (so that the Loader's
labelled/unlabelled split works) and ``input/`` the full training image
set.  It draws with Python's ``random`` in the JAX package's order, so one
seed gives the same split in both packages.  Dataset filename patterns are
arguments::

    python -m vq_seg_tpu_torch.data.sampling --dataset CWFID \\
        --data_root DATA/CWFID --save_root DATA/semi --percent 30 20 10 --seed 0

Dataset scales (reference ``__main__``): CWFID total 50 (``*_image.png``),
rice_s_n_w 180 (``image_[0-9]+.png``), IJRR2017/BoniRob 430 (every PNG).
"""
from __future__ import annotations

import os
import os.path as osp
import random
import re
from glob import glob
from shutil import copy, copytree, rmtree
from typing import Optional

DATASET_PATTERNS = {
    "CWFID": ("*_image.png", None, 50),
    "rice_s_n_w": ("*.png", r"image_[0-9]+\.png", 180),
    "IJRR2017": ("*.png", None, 430),
}


def sampling(data_root: str, save_root: str, total: int, percent: float,
             pattern: str = "*.png", fullmatch: Optional[str] = None,
             input_source: Optional[str] = None, seed: Optional[int] = None) -> str:
    """Copy the targets of ``int(total * percent / 100)`` randomly chosen
    training images (with their augmented siblings sharing the stem) into a
    semi-supervised split; returns its directory.  ``seed`` reseeds
    Python's global ``random``.  ``input_source``: the directory whose
    contents become ``train/input`` (default ``{data_root}/train/input``)."""
    if seed is not None:
        random.seed(seed)
    save_dir = osp.join(save_root, f"percent_{percent}")
    save_input = osp.join(save_dir, "train", "input")
    save_target = osp.join(save_dir, "train", "target")
    rmtree(save_dir, ignore_errors=True)
    os.makedirs(save_target, exist_ok=True)

    images = sorted(glob(osp.join(data_root, "train", "input", pattern)))
    if fullmatch:
        images = [p for p in images if re.fullmatch(fullmatch, osp.split(p)[1])]
    k = int(total * percent / 100)
    chosen = random.sample(range(len(images)), k)
    for index in chosen:
        stem = osp.splitext(osp.split(images[index])[1])[0]
        for im in glob(osp.join(data_root, "train", "input", stem + "*.png")):
            fn = osp.split(im)[1]
            copy(osp.join(data_root, "train", "target", fn), osp.join(save_target, fn))
    copytree(osp.join(data_root, "test"), osp.join(save_dir, "test"))
    copytree(input_source or osp.join(data_root, "train", "input"), save_input)
    return save_dir


def sample_dataset(name: str, data_root: str, save_root: str, percent: float,
                   seed: Optional[int] = None) -> str:
    """``sampling`` with a named dataset's pattern and total."""
    pattern, fullmatch, total = DATASET_PATTERNS[name]
    return sampling(data_root, save_root, total, percent, pattern, fullmatch, seed=seed)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Build semi-supervised percent splits")
    ap.add_argument("--dataset", choices=sorted(DATASET_PATTERNS), default="CWFID")
    ap.add_argument("--data_root", required=True,
                    help="source root with train/{input,target} and test/")
    ap.add_argument("--save_root", required=True, help="destination; writes percent_{P}/ under it")
    ap.add_argument("--percent", type=float, nargs="+", default=[30, 20, 10],
                    help="one or more label percentages (the reference builds 30/20/10)")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)
    for p in args.percent:
        print(sample_dataset(args.dataset, args.data_root, args.save_root, p, seed=args.seed))


if __name__ == "__main__":
    main()
