"""CLI evaluator, the port's ``scripts/test.py`` (reference
test_detailviz.py:31-169)::

    python -m vq_seg_tpu_torch.test --config_path config/X.json

``cfg.test.weights`` is one checkpoint or a directory; a directory is
swept and the checkpoint with the best test mIoU wins (test_detailviz.py:
60-72), a checkpoint that does not load is skipped.  Per image (batch 1,
f32): forward, the logits bilinearly resized to the native mask size,
then accuracy, mIoU, per-class IoU, precision, recall and F1; the results
are appended to ``{cfg.test.save_dir}/{run}/results.txt`` and the TP/FP
detail images written to ``imgs/``.  ``--crf`` refines each image's
softmax with ``utils/crf.py::DenseCRF`` (on the image resized to the mask
size) before scoring.  Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np
import torch

from .config import load_config
from .data import BaseDataset, Loader
from .device import resolve_device
from .metrics import Measurement
from .models.layers import resize_bilinear
from .models.networks import make_model
from .utils import visualize
from .utils.ckpoints import load_full
from .utils.crf import DenseCRF
from .utils.seg_tools import img_to_label


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).cpu().numpy()


@torch.no_grad()
def test_loop(cfg, model, weights_path, measurement, save_dir=None, save_img=False,
              use_crf=False, device="cuda"):
    """Score one checkpoint over ``{cfg.test.data_dir}/test``, with the dense
    CRF's refinement when ``use_crf``; None when it does not load."""
    device = resolve_device(device)
    dataset = BaseDataset(os.path.join(cfg.test.data_dir, "test"), "labelled", batch_size=1,
                          resize=cfg.resize, target_resize=False)
    loader = Loader(dataset, 1, shuffle=False, device=device)
    try:
        ck = load_full(weights_path)
        model.load_state_dict(ck["model_1"] if "model_1" in ck else ck)
    except Exception as e:  # a corrupt checkpoint is skipped (test_detailviz.py:88-92)
        print(f"skip {weights_path}: {e}")
        return None
    model.eval()
    crf = DenseCRF() if use_crf else None
    sums = np.zeros(5)
    iou_sums = None
    n = 0
    img_rows = []
    for batch in loader:
        img, mask = batch["img"], batch["target"]  # the mask at native size
        out = model(img)
        pred = (out[0] if isinstance(out, tuple) else out).float()
        if pred.shape[-2:] != mask.shape[-2:]:
            pred = resize_bilinear(pred, mask.shape[-2:])
        keep_img = save_img and save_dir is not None
        if crf is not None or keep_img:  # the image at the mask's size
            full = (img if img.shape[-2:] == mask.shape[-2:]
                    else resize_bilinear(img, mask.shape[-2:]))
        if crf is not None:
            prob = torch.softmax(pred[0], dim=0)
            pred = crf(full[0].permute(1, 2, 0), prob.permute(1, 2, 0)).permute(2, 0, 1)[None]
        label = img_to_label(mask, cfg.pixel_to_label)
        acc, miou_v, iou_list, precision_v, recall_v, f1 = measurement.measure(pred, label)
        sums += np.array([acc, miou_v, precision_v, recall_v, f1])
        iou_sums = np.array(iou_list) if iou_sums is None else iou_sums + np.array(iou_list)
        n += 1
        if keep_img:
            viz1, viz2 = visualize.make_test_detailed_img(_nhwc(full), _nhwc(pred),
                                                          label.cpu().numpy())
            img_rows.append((batch["filename"][0], viz1[::2, ::2], viz2[::2, ::2]))
    result = dict(test_acc=sums[0] / n, test_miou=sums[1] / n, test_precision=sums[2] / n,
                  test_recall=sums[3] / n, test_f1score=sums[4] / n,
                  iou_by_class=(iou_sums / n).tolist())
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "results.txt"), "a") as f:
            f.write(f"{weights_path}\n" + "".join(f"  {k}: {v}\n" for k, v in result.items()))
        if save_img:
            img_dir = os.path.join(save_dir, "imgs")
            os.makedirs(img_dir, exist_ok=True)
            for fn, v1, v2 in img_rows:
                stem, ext = os.path.splitext(fn)
                visualize.save_img(img_dir, stem + "_v1" + ext, v1)
                visualize.save_img(img_dir, stem + "_v2" + ext, v2)
    return result


def test(cfg, save_img=None, use_crf=False, device="cuda"):
    """Evaluate ``cfg.test.weights`` (a checkpoint or a directory of them),
    with the dense CRF when ``use_crf``.  Returns ``(path, result)`` of the
    best checkpoint, or None."""
    device = resolve_device(device)
    model = make_model(cfg.model, device=device)
    measurement = Measurement(cfg.num_classes)
    weights = cfg.test.weights
    run_name = os.path.basename(os.path.normpath(weights))
    save_dir = os.path.join(cfg.test.save_dir, run_name)
    save_img = cfg.test.get("save_img", True) if save_img is None else save_img
    candidates = sorted(glob(os.path.join(weights, "*.ckpt"))) if os.path.isdir(weights) else [weights]
    logger = None
    if cfg.get("wandb_logging"):
        from .utils.logger import TestLogger

        logger = TestLogger(cfg, run_name, offline_dir=save_dir)
    best = None
    for ck in candidates:
        res = test_loop(cfg, model, ck, measurement, save_dir=save_dir, save_img=save_img,
                        use_crf=use_crf, device=device)
        if res is None:
            continue
        print(ck, {k: round(float(v), 4) for k, v in res.items() if k != "iou_by_class"})
        if logger is not None:
            logger.log_dict.update({k: v for k, v in res.items() if k != "iou_by_class"})
            logger.table_update("results", list(res.keys()), [[str(v) for v in res.values()]])
            logger.logging()
        if best is None or res["test_miou"] > best[1]["test_miou"]:
            best = (ck, res)
    if best is not None:
        print("best:", best[0], best[1])
    if logger is not None:
        logger.finish()
    return best


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("::")[0])
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--crf", action="store_true", help="dense-CRF refinement before scoring")
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    opt = parser.parse_args(argv)
    test(load_config(opt.config_path), use_crf=opt.crf, device=opt.device)


if __name__ == "__main__":
    main()
