"""One phase of ``chip_smoke.py`` alone on one card, after the script's own
set-up (``chip_smoke.card_setup``: TF32 off, the kernel built):

  16  phase 3's model and its f32 predictor, then ``parallel_phase`` (the
      CPS step across processes, serving on a mesh of devices); phase 6's
      step is not run, so (a)'s comparison with it prints nan;
  17  ``modes_phase`` (the eleven other training modes on a mesh, ZeRO-1
      with gradient accumulation).

Usage (from the root of the repository, on a machine with a card)::

    python tools/chip_phase.py 17
"""
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def phase16(card: str):
    from vq_seg_tpu_torch import load_config
    from vq_seg_tpu_torch.models.modules import vector_quantizer
    from vq_seg_tpu_torch.models.networks import make_model
    from vq_seg_tpu_torch.ops import vq_cuda
    from vq_seg_tpu_torch.ops.vq import vq_assign_reference
    from vq_seg_tpu_torch.serving import Predictor

    cfg = load_config(cs.CONFIG)
    hw = int(cfg.resize)
    model = make_model(cfg.model, device="cuda", generator=torch.Generator().manual_seed(cs.SEED))
    rng = np.random.default_rng(cs.SEED)
    init_imgs = rng.integers(0, 256, size=(cs.BATCH, hw, hw, 3), dtype=np.uint8)
    x_init = torch.from_numpy(init_imgs).cuda().permute(0, 3, 1, 2).float() / 255.0
    model.init_codebook_(x_init, torch.Generator().manual_seed(cs.SEED + 1))
    batches = [rng.integers(0, 256, size=(cs.BATCH, hw, hw, 3), dtype=np.uint8) for _ in range(3)]
    pred32 = Predictor(model, input_hw=(hw, hw), batch_size=cs.BATCH, half=False)
    cs.parallel_phase(cfg, card, vq_cuda, vq_assign_reference, vector_quantizer, model, pred32,
                      batches, float("nan"))


def phase17(card: str):
    from vq_seg_tpu_torch import load_config
    from vq_seg_tpu_torch.ops import vq_cuda

    cs.modes_phase(load_config(cs.CONFIG), card, vq_cuda)


PHASES = {"16": phase16, "17": phase17}


def main() -> int:
    if len(sys.argv) != 2 or sys.argv[1] not in PHASES:
        print(f"usage: python tools/chip_phase.py {{{','.join(PHASES)}}}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phase: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_setup()
    t0 = time.perf_counter()
    PHASES[sys.argv[1]](card)
    print(f"phase {sys.argv[1]} in {time.perf_counter() - t0:.1f} s | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
