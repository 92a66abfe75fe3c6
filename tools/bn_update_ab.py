#!/usr/bin/env python3
"""Time the flagship CPS step with the port's BatchNorm running-stat update
against torch's own, in turns, on one NVIDIA card.

    python3 tools/bn_update_ab.py [--rounds 6] [--steps 15]

``vq_seg_tpu_torch/models/layers.py::BatchNorm2d`` blends the biased batch
variance into ``running_var``, as flax does, at the cost of three small
operations per train-mode BN (a zeroed scratch, a scale, an add).
``nn.BatchNorm2d`` blends the unbiased one inside its single call.  This
tool builds the step that ``chip_smoke.py`` trains (the flagship config at
full width: resnet50, K=512, 448x448, batch 4 + 4, bf16 autocast, random
weights from seed 0), runs its init phase, and times steps with each
update in turns: torch, port, port, torch, ...  Every round starts with
one untimed step; every step ends with a fetch of its loss scalar and
takes its own batch from a cycle of eight.  Prints the p50 of each round,
the p50 of each update over all its rounds, the card line, and last one
JSON object.  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIG = os.path.join(ROOT, "config", "vqreptunet1x1v2.json")
SEED = 0
BATCH = 4  # labeled, and as many unlabeled
N_BATCHES = 8


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--steps", type=int, default=15, help="timed steps per round")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bn_update_ab: no CUDA device", file=sys.stderr)
        return 1
    from vq_seg_tpu_torch import load_config
    from vq_seg_tpu_torch.losses import make_loss
    from vq_seg_tpu_torch.models import layers
    from vq_seg_tpu_torch.training import (cps_init_phase, create_cps_state,
                                           make_cps_train_step, make_lr_schedule)

    cfg = load_config(CONFIG)
    tc, hw = cfg.train, int(cfg.resize)
    num_classes, th, half = int(cfg.num_classes), float(tc.confidence_threshold), bool(tc.half)
    n_steps = args.rounds * 2 * (args.steps + 1) + 3
    state = create_cps_state(cfg.model, make_lr_schedule(tc, steps_per_epoch=n_steps), seed=SEED,
                             encoder_weights=None, init_weights=bool(tc.init_weights))
    weight = tc.criterion.get("weight")
    step = make_cps_train_step(
        make_loss(tc.criterion.name, num_classes, ignore_index=255, weight=weight), half=half,
        num_classes=num_classes, confidence_threshold=th, cps_loss_weight=tc.cps_loss_weight,
        commitment_loss_weight=tc.total_commitment_loss_weight,
        prototype_loss_weight=tc.total_prototype_loss_weight, ce_weight=weight)

    rng = np.random.default_rng(SEED)
    stripes = (np.arange(hw) * 6 // hw)[None, None, :]
    batches = []
    for _ in range(N_BATCHES):
        img = rng.integers(0, 256, size=(BATCH, hw, hw, 3), dtype=np.uint8)
        target = (stripes + rng.integers(0, 2, size=(BATCH, hw, hw))) % 3
        ul = rng.integers(0, 256, size=(BATCH, hw, hw, 3), dtype=np.uint8)
        batches.append(tuple(torch.from_numpy(a).cuda() for a in (img, target, ul)))

    def to_input(u8):
        return u8.permute(0, 3, 1, 2).float() / 255.0

    img, target, _ = batches[0]
    cps_init_phase(state, to_input(img), target, th, seed=SEED, half=half)
    count = [0]

    def run_step() -> float:
        img, target, ul = batches[count[0] % N_BATCHES]
        count[0] += 1
        t0 = time.perf_counter()
        _, metrics, _, _ = step(state, to_input(img), target, to_input(ul))
        float(metrics["loss"])  # the step's one read of the card
        return (time.perf_counter() - t0) * 1e3

    port_forward = layers.BatchNorm2d.forward
    forwards = {"torch": torch.nn.BatchNorm2d.forward, "port": port_forward}
    times = {"torch": [], "port": []}
    rounds = []
    card = card_line()
    for _ in range(3):
        run_step()
    try:
        for r in range(args.rounds):
            for name in (("torch", "port") if r % 2 == 0 else ("port", "torch")):
                layers.BatchNorm2d.forward = forwards[name]
                run_step()
                got = [run_step() for _ in range(args.steps)]
                times[name] += got
                rounds.append({"round": r, "update": name, "p50_ms": statistics.median(got)})
                print(f"[bn-ab] round {r} {name:5s} p50 {statistics.median(got):.3f} ms/step "
                      f"over {args.steps} steps | {card}")
    finally:
        layers.BatchNorm2d.forward = port_forward
    p50 = {name: statistics.median(t) for name, t in times.items()}
    print(f"[bn-ab] bf16 CPS step, batch {BATCH}+{BATCH}, {hw}x{hw}: torch's update p50 "
          f"{p50['torch']:.3f} ms/step, the port's {p50['port']:.3f} ms/step, difference "
          f"{p50['port'] - p50['torch']:.3f} ms over {len(times['port'])} steps each | {card}")
    print(card)
    print(json.dumps({"p50_ms": p50, "rounds": rounds, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
