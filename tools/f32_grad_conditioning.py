"""Why the flagship's f32 CPS step lies about 1e-2 (relative L2) from the
same step in f64 in the encoder's gradients, and 1e-6 in the decoder's.

Runs on the CPU with the port alone (no JAX): the ``vqreptunet1x1v2``
network with VQ on the last three stages, one CPS step from a k-means
initialised state on seeded random images, then

  * the f32 step against the f64 step (every module's activations and
    every gradient checked to be f64 there, with ``chip_smoke.py``'s
    helpers);
  * the f64 step with its weights scaled by (1 + s * N(0, 1)), s = 6e-8
    (f32's rounding) and 6e-10, against the f64 step;
  * the encoder's ReLU masks (``x > 0``) of each run against the f64
    step's: how many elements changed side;
  * the f64 step with the f32 step's ReLU masks, against the f32 step.

Usage::

    python tools/f32_grad_conditioning.py [--hw 64] [--encoder resnet50]
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import os
import statistics
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import _f64_floats, _non_f64_outputs  # noqa: E402
from vq_seg_tpu_torch.losses import make_loss  # noqa: E402
from vq_seg_tpu_torch.models.encoders import resnet  # noqa: E402
from vq_seg_tpu_torch.training import (cps_init_phase, create_cps_state,  # noqa: E402
                                       make_cps_train_step)

STEP_KW = dict(num_classes=3, confidence_threshold=0.7, cps_loss_weight=1.0,
               commitment_loss_weight=1.0, prototype_loss_weight=0.01)


def model_cfg(encoder: str) -> dict:
    return {"name": "vqreptunet1x1v2", "params": {
        "encoder_name": encoder, "num_classes": 3, "margin": 0.5, "scale": 30.0,
        "vq_cfg": {"num_embeddings": [0, 0, 64, 64, 64], "distance": "euclidean",
                   "kmeans_init": True}}}


def batches(hw: int, n: int = 4, seed: int = 0):
    """Two batches (labeled images, labels with stripes, unlabeled images)."""
    rng = np.random.default_rng(seed)
    stripes = (np.arange(hw) * 6 // hw)[None, None, :]

    def images():
        u8 = rng.integers(0, 256, (n, hw, hw, 3)).astype(np.float32) / 255
        return torch.from_numpy(u8).permute(0, 3, 1, 2).contiguous()

    return [(images(), torch.from_numpy((stripes + rng.integers(0, 2, (n, hw, hw))) % 3).long(),
             images()) for _ in range(2)]


@contextlib.contextmanager
def encoder_relus(masks: list, replay=None):
    """The encoder's ``F.relu`` records each call's mask ``x > 0`` in
    ``masks``; with ``replay``, call i returns ``x * replay[i]``."""
    class _F:
        def __getattr__(self, name):
            return getattr(F, name)

    def relu(x, inplace=False):
        masks.append(x.detach() > 0)
        if replay is not None:
            return x * replay[len(masks) - 1].to(x.dtype)
        return F.relu(x, inplace=inplace)

    shim = _F()
    shim.relu = relu
    resnet.F = shim
    try:
        yield
    finally:
        resnet.F = F


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", type=int, default=64)
    ap.add_argument("--encoder", default="resnet50")
    args = ap.parse_args()
    torch.manual_seed(0)
    (b0, b1) = batches(args.hw)
    state = create_cps_state(model_cfg(args.encoder), lambda s: 1e-4, device="cpu",
                             init_weights=True)
    cps_init_phase(state, b0[0], b0[1], STEP_KW["confidence_threshold"])
    step = make_cps_train_step(make_loss("dice_loss", 3, ignore_index=255), **STEP_KW)

    def run(dtype=torch.float32, scale=0.0, masks=None, replay=None, seen=None):
        s = copy.deepcopy(state)
        f64 = contextlib.ExitStack()
        if dtype == torch.float64:
            s.model_1.double()
            s.model_2.double()
            gen = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in (p for m in (s.model_1, s.model_2) for p in m.parameters()):
                    p.mul_(1 + scale * torch.randn(p.shape, generator=gen, dtype=p.dtype))
            f64.enter_context(_f64_floats())
            f64.enter_context(_non_f64_outputs((s.model_1, s.model_2),
                                               seen if seen is not None else []))
        with f64, encoder_relus(masks if masks is not None else [], replay):
            _, metrics, _, _ = step(s, b1[0].to(dtype), b1[1], b1[2].to(dtype))
        grads = {f"{i}.{n}": p.grad.detach().double() for i, m, _ in s.held()
                 for n, p in m.named_parameters() if p.grad is not None}
        return metrics, grads

    def report(tag, g, ref):
        errs = {k: rel(g[k], ref[k]) for k in g}
        enc = [v for k, v in errs.items() if ".encoder." in k]
        rest = [v for k, v in errs.items() if ".encoder." not in k]
        print(f"{tag}: encoder median {statistics.median(enc):.3e}, largest {max(enc):.3e}; "
              f"the rest median {statistics.median(rest):.3e}, largest {max(rest):.3e}")

    def flips(a, b):
        return sum(int((x != y).sum()) for x, y in zip(a, b)), sum(x.numel() for x in a)

    seen: list = []
    masks64, masks32 = [], []
    m64, g64 = run(torch.float64, masks=masks64, seen=seen)
    m32, g32 = run(masks=masks32)
    print(f"{args.encoder}, {args.hw}x{args.hw}, batch 4+4, torch {torch.__version__}")
    print(f"the f64 step: {len(seen)} module activations, "
          f"{sum(t.dtype != torch.float64 for t in g64.values())} gradients not in f64; "
          f"loss {float(m64['loss']):.9f} (f32: {float(m32['loss']):.9f})")
    report("f32 step against the f64 step", g32, g64)
    print("  encoder ReLU inputs on the other side of 0 than in f64: %d of %d" %
          flips(masks32, masks64))
    for scale in (6e-8, 6e-10):
        masks = []
        _, gp = run(torch.float64, scale=scale, masks=masks)
        report(f"f64 step, weights scaled by 1 + {scale:g} N(0, 1), against the f64 step", gp, g64)
        print("  encoder ReLU inputs on the other side of 0: %d of %d" % flips(masks, masks64))
    _, gr = run(torch.float64, replay=masks32)
    report("f32 step against the f64 step with the f32 step's encoder ReLU masks", g32, gr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
