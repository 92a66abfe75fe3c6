#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vq_seg_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when a
check does not hold:

1. device: a CUDA card is required; prints the ``nvidia-smi`` name and
   power limit.  TF32 is turned off for matmuls and cuDNN so that the f32
   comparisons below are f32 (phases 8 and 10 put PyTorch's defaults
   back: the ``reptcps``, ``plaincps`` and ``objcps`` trainers pin f32
   themselves).
2. build: compiles ``vq_seg_tpu_torch/csrc/vq_assign.cu`` with nvcc (or
   reuses the library built from the same source).
3. serving at full width: the flagship ``config/vqreptunet1x1v2.json``
   (resnet50, K=512, 448x448) with random weights from a seed, its k-means
   codebook init on one synthetic batch, then ``Predictor(batch_size=8,
   half=True)`` serves 3 batches through ``predict_stream``, one partial
   batch of 3 and a few timed batches.  The kernel's launch count is reset
   just before and read just after: it must be 3 per forward.
4. the kernel against its plain version on the card, at the three VQ
   shapes the serving forward hands it (captured from a forward, with the
   k-means codebooks), stage 4 again with half its codebook duplicated, a
   ragged case, a narrow case (C=3, K=5), a duplicate-row tie case and the
   cosine branch.  idx may differ only on proven near-ties, and an exact
   tie must go to the lower index in both versions.
5. f32 end to end: the Predictor's f32 logits with every VQ stage on the
   kernel against the same forward with every stage on the plain version.
   Where the plain version's choice differs from the kernel's on a proven
   near-tie (phase 4's proof, rerun on these rows), the plain path takes
   the kernel's code, so the check holds everything else to 1e-3; the
   number of such rows is printed.
6. training at full width: the flagship CPS step (``create_cps_state`` ->
   ``cps_init_phase`` -> ``make_cps_train_step``) with the config's loss
   weights, criterion, LR schedule, ``init_weights`` and bf16 autocast,
   batch 4 labeled + 4 unlabeled, random weights from a seed (pretrained
   encoders cannot be fetched).  The init phase, then 3 warm-up and 6
   timed steps on distinct synthetic batches, each ended by a fetch of the
   loss: p50/p90 ms per step, img/s (8 images per step), every loss term,
   the peak memory and a profile of 3 more steps.  The kernel's launch
   count must be 18 per step (6 forwards x 3 VQ stages); losses finite,
   parameters and BN running stats changed, codebooks bitwise unchanged.
   The kernel is held against its plain version at the three shapes of a
   train pass, and one f32 step from the post-init state with VQ on the
   kernel is held against the same step with VQ on the plain version
   (near-tie rows given the kernel's code, as in phase 5): loss terms
   within 1e-4 relative, every parameter's gradient within 1e-3 relative
   L2.
7. the driver at full width, as a user runs it: a PNG tree at CWFID's
   native 1296x966 (8 labelled + 16 unlabelled train images, 4 test
   images, striped masks) written with the port's own PNG encoder; the
   Loader's cold and warm img/s; ``train`` of the flagship config (2
   epochs of 4 bf16 steps, batch 4+4, test every epoch, checkpoints; the
   config's ``encoder_weights`` resolve to no file, and the warning must
   show), then a resumed run that must run only epoch 2 from step 8 at
   ``schedule(8)``, the test CLI's sweep over the first run's checkpoints
   and one batch served by ``Predictor.from_checkpoint`` of its
   ``last.ckpt``.  The kernel's launches are counted from 0 over each of
   the four: exactly 6 + 18 per step + 3 per test image per evaluation,
   18 per step + 3 per test image, 3 per forward, 3.  Contract keys,
   finite losses, mIoUs in [0, 1] and labels in range are checked; epoch
   times, the driver's ms per step against phase 6's p50 and the
   checkpoints' bytes and seconds are printed.  The kernel is held
   against its plain version at the evaluation forward's shapes (batch
   1).  The tree stays for phases 8 to 13 and is deleted after them.
8. the ``reptcps`` family at full width: ``config/vqreptunet1x1.json``
   (resnet50, K=512, 448x448) in f32, as the JAX driver runs it, batch 4+4
   at drop percent 80, random weights from a seed.  The phase runs under
   PyTorch's default TF32 flags (cuDNN may use TF32), so the times are
   those of the trainer's own setting: every forward of the step must see
   cuDNN's and cuBLAS's TF32 off (``device.full_f32``).  The init phase (6
   launches), 2 warm-up, 4 timed and 2 profiled steps (18 launches
   each), each ended by a loss fetch: p50/p90 ms, img/s, peak memory,
   device time per step; parameters changed except the detached
   prototype tables, codebooks unchanged.  One f32 step from the
   post-init state with VQ on the kernel against the plain VQ (near-tie
   rows given the kernel's code): loss terms within 1e-4 relative,
   gradients within 1e-3 relative L2, and the pixels on which the six
   percentile masks of the two runs disagree printed.  One step each of
   ``vqreptunet``, ``vqreeuptunet``, ``vqretemptunet`` and
   ``vqreptunetdouble1x1`` (6 + 18 launches, finite losses).  Then
   ``train_rept_cps`` for 1 epoch of 4 steps on phase 7's tree, test
   every epoch: exactly 6 + 18 x 4 + 3 x 4 = 90 launches, the
   contract keys of ``0ep.ckpt`` and ``last.ckpt``, the from-scratch
   warning.
9. the supervised baseline at full width, bf16 as the configs set it:
   ``only_sup_kmeans.json`` (``vqunet_v2``, 512x512, batch 4: 3 launches
   at init and 3 per step) and ``CWFID_Unet.json`` (``unet``, batch 8: no
   launch), each 3 warm-up, 6 timed and 3 profiled steps: p50, peak
   memory, device time per step; the kernel against its plain version at
   ``vqunet_v2``'s shapes.  Then the sup driver for one epoch on the
   tree: 3 + 3 per step launches and ``last.ckpt`` holding exactly
   ``{"model_1", "epoch"}``.
10. ``plaincps`` and ``objcps`` with the attention networks at full width,
   f32 as the JAX drivers run them, under PyTorch's default TF32 flags
   (every forward must see TF32 off): ``config/vqcanet.json`` (resnet50,
   CCA at the bottleneck, K=512, 512², batch 4+4) through
   ``plain_init_phase`` (6 launches), 2 warm-up, 5 timed and 2 profiled
   steps (12 launches each): p50/p90, peak memory, device time per step;
   ``vqcanet_obj_loss.json`` likewise with 1 warm-up and 3 timed steps;
   each the kernel step against the plain VQ (loss terms within 1e-4,
   gradients within 1e-3).  One step of each of the 16 shipped
   ``plaincps``/``objcps`` configs at its own width and resize with its
   exact launch count (3 per forward; ``drsavqunet`` 1, the ConvNeXt
   config 2, ``vqsegheadnet`` 4) and its peak memory; the kernel against
   its plain version at the new shapes (ConvNeXt-base's, ``vqatunet``'s
   256², the K=3 head's (200704, 32, 3), a K=3 and a 130-code case).
   Then ``train_plain_cps`` for 1 epoch (66 launches) and
   ``train_obj_cps`` for 1 (66) on phase 7's tree, the test CLI's sweep
   (24) and ``Predictor.from_checkpoint`` (3).
11. ``vqpt`` and ``easyhard`` with the (x, gt) networks at full width, f32
   as the JAX drivers run them, under PyTorch's default TF32 flags (every
   forward must see TF32 off): ``config/vq_pt_unet.json`` (``vqptunet``,
   resnet50, K=512, 448², batch 4+4) through ``vqpt_init_phase`` (6
   launches), 2 warm-up, 5 timed and 2 profiled steps (18 launches each:
   2 pseudo and 4 train forwards): p50/p90, peak memory, device time per
   step; ``vq_pt_unet_easyhard.json`` (512²) likewise with 1 warm-up and 3
   timed steps, its masks and flips drawn as the driver draws them; each
   the kernel step against the plain VQ (loss terms within 1e-4,
   gradients within 1e-3; easyhard with one fixed box and a width flip).
   One step of each of the other 5 shipped ``vqpt`` configs at its own
   width and resize (6 + 18 launches) with its peak memory.  Then, on
   phase 7's tree, ``train_vqpt_cps`` for 1 epoch (90 launches), a
   ``vqpt`` epoch with ``train.pretrained`` from the files ``save_vqvae``
   wrote of its model 1 (90; the encoder's parameters bitwise as loaded
   after it, its running statistics moved), ``train_easyhard_cps`` for 1
   epoch (78, no evaluation), the test CLI's sweep (24) and
   ``Predictor.from_checkpoint`` (3).  Each expected count is derived from
   the config's VQ stages, and the measured counts are printed.
12. ``angularv3``, ``supconcps``, ``semiweed`` and ``selfsup`` at full
   width, f32 as the JAX drivers run them, under PyTorch's default TF32
   flags (every forward must see TF32 off):
   ``config/vqreptunetangularv3.json`` (resnet50, K=512, 448², batch 4+4)
   and ``sup_con_loss.json`` (512²) through their init phases (6 launches),
   1 warm-up, 3 timed and 1 profiled step (18 launches each; peak memory
   printed), each with the kernel step against the plain VQ (loss terms
   within 1e-6 relative, gradients within 1e-4); one ``reptcps`` step of
   ``vqreptunetangular.json`` (6 + 18, and its kernel step likewise);
   ``semiweednet.json`` (448², batch 4: no launch) and
   ``vqvaev2_selfsup.json`` (448², batch 4: 3 at init, 3 per step), 1
   warm-up, 3 timed and 1 profiled step each.  Then, on phase 7's tree,
   one epoch of each driver (``train_angularv3_cps``, ``train_supcon_cps``
   and ``train_rept_cps`` of ``vqreptunetangular.json``: 90 launches each;
   ``train_semiweed``: 0, ``last.ckpt`` = ``{model_1, epoch,
   optimizer_1}``; ``train_selfsup`` over the 24 train images: 3 + 3 x 6),
   a ``train_vqpt_cps`` epoch with ``train.pretrained`` naming the files
   the selfsup run wrote (90; its encoder's parameters bitwise as loaded,
   its codebooks the selfsup run's), the test CLI and
   ``Predictor.from_checkpoint`` on the angularv3 run's ``last.ckpt`` (12,
   3).
13. ``config/obia_CWFID.json``, ``unimatch``, ``salientcps`` and the rest of
   the registry at full width.  The host work first, in worker processes:
   an OBIA tree (8 labelled, 8 unlabelled and 4 test images at
   ``OBIA_WH``) whose ``obia/`` pseudo-masks the port's
   ``build_pseudo_labels`` writes (SLIC, features, its own forest), and
   the port's ``get_saliency_rbd`` maps of a 448x448 tree; their seconds
   are printed.  (a) ``obia_CWFID.json`` (fcn32s on vgg19, 512x512, batch
   8, bf16): 2 warm-up and 3 timed steps (p50, peak memory) and one
   profiled, then the sup driver for one epoch on the OBIA tree (the
   unresolved ``imagenet`` weights must warn), the test CLI's sweep and
   ``Predictor.from_checkpoint``: no launch.  (b) ``--mode unimatch`` at
   ``semiweednet.json``'s width (resnet50 at output stride 16, 448x448,
   batch 4+4, f32): 2 warm-up, 3 timed and 1 profiled step, then
   ``train_unimatch`` for one epoch on phase 7's tree with its
   evaluation: no launch.  (c) ``--mode salientcps`` at the flagship's
   width (``VQUnetwithSalientloss``, resnet50, K=512, 448x448, batch 4+4,
   f32): the init phase (exactly 6 launches), 2 warm-up, 3 timed and 1
   profiled step (exactly 12 each), the kernel against its plain version
   at a train pass's shapes, the kernel step against the plain-VQ step
   (loss terms within 1e-6, gradients within 1e-4), and
   ``train_salient_cps`` for one epoch on the saliency tree (6 + 12 per
   step).  (d) one step of ``vqunet_v1`` (resnet50, K=512 at the deepest
   stage, 448x448, sup, bf16: exactly 1 launch per forward, and the kernel
   at its (4 x 14^2, 2048, 512) shape) and ``unetoriginal`` (512x512, no
   launch), and one ``cps`` step of ``nopt`` and ``scheme6`` (the
   flagship's config with the name swapped: 6 at init, 18 per step).
14. one ``{"kernels": [...]}`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Imports only the port, torch, numpy and the standard library.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "config", "vqreptunet1x1v2.json")
SEED = 0
BATCH = 8
PARTIAL = 3
STREAM_BATCHES = 3
# 60 timed calls leave 6 samples above the p90 that is reported (phases
# 3, 6, 8 and 9 take fewer samples since phase 10 came, to keep the
# script's command time near 300 s)
TIMED_BATCHES = 60
THROUGHPUT_BATCHES = 15
PROFILED_BATCHES = 5
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
E2E_TOL = 1e-3
TRAIN_BATCH = 4  # labeled, and as many unlabeled
TRAIN_WARMUP = 3
# timed and profiled samples are cut phase by phase to keep the script's
# command time under 420 s with phase 12
TRAIN_TIMED = 6
TRAIN_PROFILED = 3
VQ_PER_STEP = 18  # 6 forwards x 3 VQ stages
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 1e-3
LOSS_TERMS = ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "commitment_loss",
              "prototype_loss")
# phase 7: the driver on a PNG tree at CWFID's native size
DRIVER_WH = (1296, 966)
DRIVER_LABELLED, DRIVER_UNLABELLED, DRIVER_TEST = 8, 16, 4
DRIVER_EPOCHS = 2
# phases 8, 10 and 11 run their drivers for one epoch (phase 7's resume
# needs two)
VARIANT_DRIVER_EPOCHS = 1
# phase 8: the reptcps family, f32 as the JAX driver runs it
REPT_CONFIG = os.path.join(ROOT, "config", "vqreptunet1x1.json")
REPT_SIBLINGS = ("vqreptunet", "vqreeuptunet", "vqretemptunet", "vqreptunetdouble1x1")
REPT_DROP = 80.0
REPT_WARMUP, REPT_TIMED, REPT_PROFILED = 2, 4, 2
# phase 9: the supervised baseline; (config, kernel launches per step)
SUP_CONFIGS = (("only_sup_kmeans", 3), ("CWFID_Unet", 0))
SUP_WARMUP, SUP_TIMED, SUP_PROFILED = 3, 6, 3
# phase 10: plaincps / objcps with the attention networks, f32 as the JAX
# drivers run them; config -> VQ launches per forward
PLAIN_CONFIG, OBJ_CONFIG = "vqcanet", "vqcanet_obj_loss"
PLAIN_WARMUP, PLAIN_TIMED, PLAIN_PROFILED = 2, 5, 2
OBJ_WARMUP, OBJ_TIMED = 1, 3
PLAIN_CONFIGS = {"vqcanet": 3, "vqcanet_obj_loss": 3, "cps_vqv2": 3, "cps_vqv2_kmeans_init": 3,
                 "cps_vqv2_kmeans_with_imagenet_weights": 3, "cps_vqv2_match": 3, "vq_": 3,
                 "vqatunet": 3, "vqcanetv2": 3, "vqcanetv3": 3, "vqcanetv4": 3,
                 "drsavqunet": 1, "vqpatchunet": 3, "vqsegheadnet": 4, "vqcanet_convnext": 2,
                 "vqimdbnet": 3}
OBJ_CONFIGS = ("vqcanet_obj_loss", "vqimdbnet")
# configs whose VQ shapes are new to the kernel: captured and held against
# the plain version
NEW_SHAPE_CONFIGS = ("vqcanet_convnext", "vqatunet", "vqsegheadnet")
PLAIN_TERMS = ("loss", "cps_loss", "sup_loss_1", "sup_loss_2")
OBJ_TERMS = ("loss", "cps_loss", "sup_loss", "obj_loss", "commitment_loss")
# phase 11: vqpt / easyhard with the (x, gt) networks, f32 as the JAX
# drivers run them
VQPT_CONFIG, EASYHARD_CONFIG = "vq_pt_unet", "vq_pt_unet_easyhard"
VQPT_WARMUP, VQPT_TIMED, VQPT_PROFILED = 2, 5, 2
EASYHARD_WARMUP, EASYHARD_TIMED = 1, 3
VQPT_CONFIGS = ("vq_eu_pt_unet", "vq_nedpt_unet", "vqash", "vqash_deep", "vqashv2")
EASYHARD_TERMS = ("loss", "cps_loss", "sup_loss", "commitment_loss", "prototype_loss")
# phase 12: angularv3, supconcps, the vqreptunetangular reptcps step,
# semiweed and selfsup, f32 as the JAX drivers run them
ANGULAR_CONFIG, SUPCON_CONFIG = "vqreptunetangularv3", "sup_con_loss"
ANGULAR_REPT_CONFIG, SEMIWEED_CONFIG, SELFSUP_CONFIG = ("vqreptunetangular", "semiweednet",
                                                       "vqvaev2_selfsup")
SLICE_WARMUP, SLICE_TIMED, SLICE_PROFILED = 1, 3, 1
# the kernel step against the plain VQ, near-tie rows given the kernel's code
SLICE_LOSS_TOL, SLICE_GRAD_TOL = 1e-6, 1e-4
ANGULAR_TERMS = LOSS_TERMS
SUPCON_TERMS = ("loss", "cps_loss", "sup_loss", "sup_con_loss", "commitment_loss")
SEMIWEED_TERMS = ("loss", "ce_loss", "dc_loss")
SELFSUP_TERMS = ("loss", "recon_loss", "commitment_loss")
# phase 13: obia_CWFID.json (fcn32s), unimatch, salientcps and the rest of
# the registry; OBIA's tree at OBIA_WH (SLIC and the forest on the host),
# the saliency maps at the salientcps resize
OBIA_CONFIG = "obia_CWFID"
OBIA_WH, SALIENT_WH = 256, 448
REST_LABELLED, REST_UNLABELLED = 8, 8
REST_WARMUP, REST_TIMED = 2, 3
SALIENT_TERMS = ("loss", "cps_loss", "salient_loss", "commitment_loss")
# the device kernels of csrc/vq_assign.cu, as the profiler names them
VQ_KERNEL_NAMES = ("void (anonymous namespace)::vq_mma_kernel",
                   "void (anonymous namespace)::vq_finish_kernel")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def vq_bound_ms(n: int, c: int, k: int):
    """Least time for the kernel's work.  The kernel does the 2NKC product as
    three TF32 tensor-core products (3xTF32), so its operations bound is
    3 * 2NKC at the card's dense TF32 rate; the f32 SIMT bound, 2NKC at the
    non-tensor f32 rate, is the bound of an FMA kernel and is kept beside it.
    Bytes: x, E, ||e||^2 read once plus idx and counts written once, at HBM
    bandwidth.  Returns (ops_ms, bytes_ms, f32_simt_ms)."""
    ops_ms = 3 * 2.0 * n * k * c / TF32_FLOPS * 1e3
    bytes_ms = (n * c * 4 + k * c * 4 + k * 4 + n * 4 + k * 4) / HBM_BYTES_PER_S * 1e3
    f32_simt_ms = 2.0 * n * k * c / F32_FLOPS * 1e3
    return ops_ms, bytes_ms, f32_simt_ms


def profile_window(run, n: int, unit: str, tag: str, label: str, card: str):
    """Where the device time of ``n`` calls of ``run(i)`` goes: a
    ``torch.profiler`` window over them.  Prints the share of the window's
    host wall time in which the card ran a kernel or a copy, the VQ
    kernel's share of the device time, and the kernels with the most device
    time, per ``unit``.  Returns ``{"device_ms", "vq_ms", "busy"}`` per
    ``unit``, or None (and prints "not measured") when the trace holds no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels and copies; a user annotation on the device timeline (the
    # optimizer's step range) overlaps the kernels it holds and is left out
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        print(f"[{tag}] device time not measured: the trace holds no CUDA activity | {card}")
        return None
    busy_us, end = 0.0, float("-inf")
    for s, e, _ in spans:  # length of the union of the device intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name: dict = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    device_us = sum(by_name.values())
    vq_us = sum(t for name, t in by_name.items() if name.startswith(VQ_KERNEL_NAMES))
    per = 1e3 * n
    print(f"[{tag}] {label}: device busy {100 * busy_us / wall_us:.1f}% of "
          f"{wall_us / per:.3f} ms/{unit} wall; device time {device_us / per:.3f} ms/{unit}, "
          f"vq_assign kernels {vq_us / per:.3f} ms/{unit} ({100 * vq_us / device_us:.1f}%), "
          f"{len(spans) / n:.0f} device activities per {unit} | {card}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, t in ranked[:8] + [kv for kv in ranked[8:] if kv[0].startswith(VQ_KERNEL_NAMES)]:
        print(f"[{tag}]   {t / per:8.3f} ms/{unit} {100 * t / device_us:5.1f}%  {name[:90]}")
    return {"device_ms": device_us / per, "vq_ms": vq_us / per, "busy": busy_us / wall_us}


def first_duplicate(cb: torch.Tensor) -> torch.Tensor:
    """For each code, the lowest index of a bitwise-identical codebook row."""
    _, inverse = torch.unique(cb, dim=0, return_inverse=True)
    k = cb.shape[0]
    first = torch.full((int(inverse.max()) + 1,), k, dtype=torch.int64, device=cb.device)
    first.scatter_reduce_(0, inverse, torch.arange(k, device=cb.device), reduce="amin")
    return first[inverse]


def check_near_ties(name, x, cb, i_k, i_r, metric):
    """Rows where the kernel (i_k) and the plain version (i_r) chose
    different codes must be proven near-ties: the two codes' scores,
    recomputed in f64, lie within the f32 error of both versions.  Each
    score's dot product over C terms errs by at most C*2^-24*sum|x_i e_i|
    (doubled by the -2 of the euclidean score), ||e||^2 by at most
    C*2^-24*||e||^2, and the final add by one rounding.  Returns those rows
    and the largest f64 score gap between the two choices (0.0 when they
    agree everywhere); raises if any mismatch is wider than its bound."""
    rows = torch.nonzero(i_k != i_r).flatten()
    if rows.numel() == 0:
        return rows, 0.0
    c = x.shape[1]
    u = 2.0 ** -24
    xr = x[rows].double()
    ea, eb = cb[i_k[rows].long()].double(), cb[i_r[rows].long()].double()
    dots = (xr * ea).abs().sum(-1) + (xr * eb).abs().sum(-1)
    if metric == "euclidean":
        sq_a, sq_b = (ea * ea).sum(-1), (eb * eb).sum(-1)
        sa = sq_a - 2.0 * (xr * ea).sum(-1)
        sb = sq_b - 2.0 * (xr * eb).sum(-1)
        tol = 2.0 * c * u * dots + c * u * (sq_a + sq_b) + 2.0 * u * (sa.abs() + sb.abs())
    else:
        sa, sb = -(xr * ea).sum(-1), -(xr * eb).sum(-1)
        tol = c * u * dots + 2.0 * u * (sa.abs() + sb.abs())
    gap = (sa - sb).abs()
    bad = int((gap > tol).sum())
    check(bad == 0, f"{name}: {bad} of {rows.numel()} idx mismatches are not near-ties "
                    f"(max gap {float(gap.max()):.3e}, tol there {float(tol[gap.argmax()]):.3e})")
    return rows, float(gap.max())


def compare_vq(name, x, cb, metric, vq_cuda, vq_assign_reference) -> dict:
    """Kernel against the plain version, both on the card.  Returns the
    case's numbers; raises on a disagreement."""
    n, c = x.shape
    k = cb.shape[0]
    i_k, q_k, c_k = vq_cuda.vq_assign_cuda(x, cb, metric)
    i_r, q_r, _ = vq_assign_reference(x, cb, metric)
    torch.cuda.synchronize()
    i_k64, i_r64 = i_k.long(), i_r.long()
    check(torch.equal(q_k, cb.index_select(0, i_k64)), f"{name}: quant != codebook[idx]")
    check(torch.equal(c_k, torch.bincount(i_k64, minlength=k).to(torch.int32)),
          f"{name}: counts != bincount(idx)")
    check(int(c_k.sum()) == n, f"{name}: counts sum {int(c_k.sum())} != N {n}")
    first = first_duplicate(cb)
    check(torch.equal(first[i_k64], i_k64), f"{name}: kernel chose a duplicate code over a lower index")
    check(torch.equal(first[i_r64], i_r64),
          f"{name}: plain version chose a duplicate code over a lower index")
    rows, score_gap = check_near_ties(name, x, cb, i_k, i_r, metric)
    same = torch.ones_like(i_k, dtype=torch.bool)
    same[rows] = False
    check(torch.equal(q_k[same], q_r[same]), f"{name}: quant differs on rows with the same idx")
    ms = cuda_ms(lambda: vq_cuda.vq_assign_cuda(x, cb, metric))
    plain_ms = cuda_ms(lambda: vq_assign_reference(x, cb, metric))
    ops_ms, bytes_ms, f32_simt_ms = vq_bound_ms(n, c, k)
    # max_abs_err: the largest f64 score gap between the code the kernel
    # chose and the code the plain version chose (0 where idx agree)
    return {"case": name, "n": n, "c": c, "k": k, "metric": metric,
            "near_ties": int(rows.numel()),
            "duplicate_rows": k - int(torch.unique(cb, dim=0).shape[0]),
            "max_abs_err": score_gap, "ms": ms, "plain_ms": plain_ms,
            "tflops": 2.0 * n * k * c / ms * 1e-9,
            "bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "f32_simt_bound_ms": max(f32_simt_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def plain_vq_with_kernel_ties(vq_cuda, vq_assign_reference, substituted: list):
    """The plain version as a drop-in ``vq_assign``, except that where its
    code differs from the kernel's on a proven near-tie (``check_near_ties``)
    the row takes the kernel's code; the number of such rows per call is
    appended to ``substituted``."""
    def plain_vq_assign(x, codebook, metric="euclidean"):
        x = x.detach()
        i_r, _, _ = vq_assign_reference(x, codebook, metric)
        i_k, _, _ = vq_cuda.vq_assign_cuda(x, codebook, metric)
        rows, _ = check_near_ties("e2e", x, codebook, i_k, i_r, metric)
        i_r[rows] = i_k[rows]
        substituted.append(int(rows.numel()))
        quantized = codebook.index_select(0, i_r.long())
        counts = torch.bincount(i_r.long(), minlength=codebook.shape[0]).to(torch.int32)
        return i_r, quantized, counts

    return plain_vq_assign


def kernel_vs_plain_step(run, post_init, vq_cuda, vq_assign_reference, vector_quantizer,
                         terms=LOSS_TERMS):
    """``run(state) -> metrics`` once on a copy of ``post_init`` with VQ on
    the kernel, then on ``post_init`` itself with VQ on the plain version
    (near-tie rows given the kernel's code).  A step clears the gradients
    before its backward and leaves them after it, so each parameter's
    ``.grad`` is the step's gradient.  Returns (the loss terms' largest
    relative difference, the gradients' largest relative L2 difference,
    the parameter where it is, the near-tie rows substituted per VQ
    call)."""
    kernel_state = copy.deepcopy(post_init)
    m_kernel = run(kernel_state)
    substituted = []
    restore = swap_vq_assign(vector_quantizer,
                             plain_vq_with_kernel_ties(vq_cuda, vq_assign_reference, substituted))
    try:
        m_plain = run(post_init)
    finally:
        restore()
    loss_err = max(abs(float(m_kernel[k]) - float(m_plain[k])) / max(abs(float(m_plain[k])), 1e-30)
                   for k in terms)
    grad_err, worst = 0.0, ""
    for mk, mp in ((kernel_state.model_1, post_init.model_1),
                   (kernel_state.model_2, post_init.model_2)):
        plain_params = dict(mp.named_parameters())
        for name, p in mk.named_parameters():
            if p.grad is None:  # a detached table: no gradient in either run
                check(plain_params[name].grad is None, f"{name}: a gradient only in the plain run")
                continue
            err = rel_l2(p.grad, plain_params[name].grad)
            if err > grad_err:
                grad_err, worst = err, name
    return loss_err, grad_err, worst, substituted


def train_batches(rng, n: int, hw: int, batch: int = TRAIN_BATCH):
    """``n`` distinct (labeled uint8 images, labels, unlabeled uint8 images)
    batches of ``batch`` on the card.  Labels are vertical stripes a sixth of the width
    wide, each pixel shifted by 0 or 1 class at random, so that every class
    appears in every image."""
    stripes = (np.arange(hw) * 6 // hw)[None, None, :]
    out = []
    for _ in range(n):
        l_img = rng.integers(0, 256, size=(batch, hw, hw, 3), dtype=np.uint8)
        target = (stripes + rng.integers(0, 2, size=(batch, hw, hw))) % 3
        ul_img = rng.integers(0, 256, size=(batch, hw, hw, 3), dtype=np.uint8)
        out.append(tuple(torch.from_numpy(a).cuda() for a in (l_img, target, ul_img)))
    return out


def to_input(img_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 on the card -> (B, 3, H, W) f32 in [0, 1]."""
    return img_u8.permute(0, 3, 1, 2).float() / 255.0


def batch_cache(seed: int):
    """``batches_for(hw, n)``: at least ``n`` ``train_batches`` at ``hw``,
    drawn from ``seed`` and kept per size."""
    cache: dict = {}

    def batches_for(hw: int, n: int):
        if cache.get(hw, (None, 0))[1] < n:
            cache[hw] = (train_batches(np.random.default_rng(seed), n, hw), n)
        return cache[hw][0]

    return batches_for


def step_runner(step, state, batches):
    """``run_step(i)``: ``step`` on ``batches[i]``, ended by the fetch of
    its loss, the step's one read of the card; the last metrics are kept
    in ``run_step.metrics``."""
    def run_step(i):
        l_img, target, ul_img = batches[i]
        _, metrics = step(state, to_input(l_img), target, to_input(ul_img))
        run_step.metrics = metrics
        return float(metrics["loss"])
    return run_step


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def train_phase(cfg, card: str, vq_cuda, vq_assign_reference, vector_quantizer) -> dict:
    """Phase 6: the flagship CPS step at full width.  Returns the training
    path's kernel launches and the kernel's cases at the training shapes."""
    from vq_seg_tpu_torch.losses import make_loss
    from vq_seg_tpu_torch.training import (cps_init_phase, create_cps_state,
                                           make_cps_train_step, make_lr_schedule)

    hw = int(cfg.resize)
    num_classes = int(cfg.num_classes)
    tc = cfg.train
    th = float(tc.confidence_threshold)
    half = bool(tc.half)
    n_steps = TRAIN_WARMUP + TRAIN_TIMED + TRAIN_PROFILED
    batches = train_batches(np.random.default_rng(SEED), n_steps, hw)
    state = create_cps_state(cfg.model, make_lr_schedule(tc, steps_per_epoch=n_steps), seed=SEED,
                             encoder_weights=None, init_weights=bool(tc.init_weights))
    criterion = tc.criterion
    step_kw = dict(num_classes=num_classes, confidence_threshold=th,
                   cps_loss_weight=tc.cps_loss_weight,
                   commitment_loss_weight=tc.total_commitment_loss_weight,
                   prototype_loss_weight=tc.total_prototype_loss_weight,
                   ce_weight=criterion.get("weight"))
    dice = make_loss(criterion.name, num_classes, ignore_index=255, weight=criterion.get("weight"))
    step = make_cps_train_step(dice, half=half, **step_kw)
    print(f"[train] {cfg.model.params.encoder_name}, num_embeddings "
          f"{list(cfg.model.params.vq_cfg.num_embeddings)}, {hw}x{hw}, batch {TRAIN_BATCH} "
          f"labeled + {TRAIN_BATCH} unlabeled, {'bf16 autocast' if half else 'f32'}, th {th}, "
          f"criterion {criterion.name}, {tc.lr_scheduler.name} from lr {tc.learning_rate}, "
          f"init_weights {bool(tc.init_weights)}; the config's encoder_weights "
          f"{cfg.model.params.get('encoder_weights')!r} are not fetched: random weights from "
          f"seed {SEED}")

    # the init phase on the first labeled batch
    l_img, target, _ = batches[0]
    vq_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cps_init_phase(state, to_input(l_img), target, th, seed=SEED, half=half)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_launches = vq_cuda.launches
    models = (state.model_1, state.model_2)
    uniq = [[int(torch.unique(vq.embedding, dim=0).shape[0]) for vq in m.core.codebooks
             if hasattr(vq, "embedding")] for m in models]
    print(f"[train] init phase in {init_s:.2f} s ({init_launches} vq_assign launches); unique "
          f"codebook rows per VQ stage, model 1 {uniq[0]}, model 2 {uniq[1]}")
    check(init_launches == 6, f"init phase launched the kernel {init_launches} times, expected 6")
    for m in models:
        check(bool(torch.isfinite(m.prototype_loss.embedding).all()), "non-finite prototype table")
    post_init = copy.deepcopy(state)
    before = [{k: v.detach().clone() for k, v in m.state_dict().items()} for m in models]

    # the main path: warm-up and timed steps, each on its own batch
    def run_step(i):
        l_img, target, ul_img = batches[i]
        _, metrics, _, _ = step(state, to_input(l_img), target, to_input(ul_img))
        loss = float(metrics["loss"])  # the step's one read of the card
        return metrics, loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vq_cuda.launches = 0
    times, per_step, losses = [], [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        n0 = vq_cuda.launches
        t0 = time.perf_counter()
        metrics, loss = run_step(i)
        dt = (time.perf_counter() - t0) * 1e3
        per_step.append(vq_cuda.launches - n0)
        losses.append(loss)
        if i >= TRAIN_WARMUP:
            times.append(dt)
    launches = vq_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    check(all(n == VQ_PER_STEP for n in per_step),
          f"vq_assign launches per step {per_step}, expected {VQ_PER_STEP} each")
    check(all(np.isfinite(losses)), f"non-finite step losses {losses}")
    terms = {k: float(metrics[k]) for k in LOSS_TERMS}
    check(all(np.isfinite(list(terms.values()))), f"non-finite loss terms {terms}")
    step_miou = float(metrics["miou"])
    check(0.0 <= step_miou <= 1.0, f"miou {step_miou} outside [0, 1]")
    for m, old, name in zip(models, before, ("model 1", "model 2")):
        sd = m.state_dict()
        params = dict(m.named_parameters())
        same = [k for k in params if torch.equal(sd[k], old[k])]
        check(not same, f"{name}: parameters unchanged by {len(per_step)} steps: {same[:5]}")
        check(not torch.equal(sd["prototype_loss.embedding"], old["prototype_loss.embedding"]),
              f"{name}: prototype table unchanged")
        moved = [k for k in sd if "codebooks" in k and not torch.equal(sd[k], old[k])]
        check(not moved, f"{name}: codebooks changed by the steps: {moved}")
        stats = [k for k in sd if k.endswith("running_mean") or k.endswith("running_var")]
        check(all(not torch.equal(sd[k], old[k]) for k in stats),
              f"{name}: BN running stats unchanged")
    p50 = statistics.median(times)
    p90 = statistics.quantiles(times, n=10, method="inclusive")[-1]
    print(f"[train] {len(per_step)} steps ({TRAIN_WARMUP} warm-up), {launches} vq_assign launches "
          f"({VQ_PER_STEP} per step); parameters of both models changed (prototype tables "
          f"included), codebooks bitwise unchanged, BN running stats changed")
    print(f"[train] {'bf16' if half else 'f32'} CPS step, batch {TRAIN_BATCH}+{TRAIN_BATCH}, "
          f"{hw}x{hw}: p50 {p50:.3f} ms/step ({2 * TRAIN_BATCH * 1e3 / p50:.1f} img/s), "
          f"p90 {p90:.3f} ms over {TRAIN_TIMED} steps (min {min(times):.3f}, max "
          f"{max(times):.3f} ms); peak memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) | {card}")
    print(f"[train] last step: " + ", ".join(f"{k} {v:.6f}" for k, v in terms.items())
          + f", miou {step_miou:.6f}, code_usage "
          + str([round(float(u), 4) for u in metrics["code_usage"]]))
    prof = profile_window(lambda i: run_step(TRAIN_WARMUP + TRAIN_TIMED + i),
                          TRAIN_PROFILED, "step", "train-profile",
                          f"bf16 CPS step, batch {TRAIN_BATCH}+{TRAIN_BATCH}", card)
    vq_ms_per_step = prof["vq_ms"] if prof else None

    # the kernel at the three shapes of a train pass
    probe = copy.deepcopy(state.model_1).train()
    l_img, target, _ = batches[1]

    def train_pass():
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16, enabled=half):
            probe(to_input(l_img), target, th, train=True)

    captured = capture_vq_shapes(vector_quantizer, train_pass)
    del probe
    check(len(captured) == 3, f"captured {len(captured)} VQ calls of a train pass, expected 3")
    cases = []
    for i, (x, cb, metric) in enumerate(captured):
        r = compare_vq(f"train-stage{3 + i}", x, cb, metric, vq_cuda, vq_assign_reference)
        cases.append(r)
        print(f"[train-kernel] vq_assign {r['case']} N={r['n']} C={r['c']} K={r['k']}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; f32 SIMT bound {r['f32_simt_bound_ms']:.4f}); near-tie rows "
              f"{r['near_ties']} (max f64 score gap {r['max_abs_err']:.3e}) | {card}")

    # one f32 step from the post-init state: VQ on the kernel against VQ on
    # the plain version
    del state
    step32 = make_cps_train_step(dice, half=False, **step_kw)
    l_img, target, ul_img = batches[1]
    loss_err, grad_err, worst, substituted = kernel_vs_plain_step(
        lambda st: step32(st, to_input(l_img), target, to_input(ul_img))[1], post_init,
        vq_cuda, vq_assign_reference, vector_quantizer)
    print(f"[train-e2e] f32 CPS step from the post-init state, VQ on the kernel vs on the plain "
          f"version: loss terms max relative difference {loss_err:.3e} (limit {STEP_LOSS_TOL}), "
          f"gradients max relative L2 {grad_err:.3e} at {worst} (limit {STEP_GRAD_TOL}); "
          f"near-tie rows given the kernel's code in the plain run, per VQ call: {substituted}")
    check(len(substituted) == VQ_PER_STEP, f"plain step made {len(substituted)} VQ calls")
    check(loss_err <= STEP_LOSS_TOL, f"f32 step loss terms differ by {loss_err}")
    check(grad_err <= STEP_GRAD_TOL, f"f32 step gradient of {worst} differs by {grad_err}")
    return {"launches": launches, "per_step": per_step, "cases": cases,
            "vq_ms_per_step": vq_ms_per_step, "p50": p50}


def write_tree(root: str, rng) -> int:
    """A CWFID-like PNG tree at the dataset's native 1296x966: train/ with
    DRIVER_LABELLED labelled and DRIVER_UNLABELLED unlabelled images, test/
    with DRIVER_TEST labelled ones.  Masks are vertical stripes of
    0/128/255 a sixth of the width wide, moved by 0 or 1 class in
    32-pixel cells; images are the stripes' colours plus noise.  Returns
    the bytes written."""
    from vq_seg_tpu_torch.utils.visualize import write_png

    w, h = DRIVER_WH
    stripes = (np.arange(w) * 6 // w)[None, :]
    colours = np.array([[40, 40, 40], [60, 160, 60], [160, 60, 60]], np.int16)
    total = 0
    for split, n_lab, n_unlab in (("train", DRIVER_LABELLED, DRIVER_UNLABELLED),
                                  ("test", DRIVER_TEST, 0)):
        for sub in ("input", "target"):
            os.makedirs(os.path.join(root, split, sub))
        for i in range(n_lab + n_unlab):
            shift = np.kron(rng.integers(0, 2, (h // 32 + 1, w // 32 + 1)), np.ones((32, 32), int))
            label = (stripes + shift[:h, :w]) % 3
            noise = rng.integers(-48, 48, (h, w, 3))
            img = np.clip(colours[label] + noise, 0, 255).astype(np.uint8)
            path = os.path.join(root, split, "input", f"im{i:03d}.png")
            write_png(path, img, level=1)
            total += os.path.getsize(path)
            if i < n_lab:
                path = os.path.join(root, split, "target", f"im{i:03d}.png")
                write_png(path, np.array([0, 128, 255], np.uint8)[label], level=1)
                total += os.path.getsize(path)
    return total


def driver_phase(cfg, card: str, vq_cuda, vq_assign_reference, vector_quantizer,
                 step_p50: float, root: str) -> dict:
    """Phase 7: the CPS driver at full width, as a user runs it (``train``
    of the flagship config on a PNG tree, resume, the test CLI's sweep and
    ``Predictor.from_checkpoint``).  Returns the phase's kernel launches and
    the kernel's cases at the evaluation shapes."""
    import warnings

    from vq_seg_tpu_torch import test as test_cli
    from vq_seg_tpu_torch.data import BaseDataset, Loader
    from vq_seg_tpu_torch.serving import Predictor
    from vq_seg_tpu_torch.training import make_lr_schedule, train
    from vq_seg_tpu_torch.utils import ckpoints

    t0 = time.perf_counter()
    png_bytes = write_tree(root, np.random.default_rng(SEED))
    print(f"[driver] synthetic tree at {DRIVER_WH[0]}x{DRIVER_WH[1]}: {DRIVER_LABELLED} "
          f"labelled + {DRIVER_UNLABELLED} unlabelled train, {DRIVER_TEST} test images, "
          f"{png_bytes / 1e6:.1f} MB of PNG written in {time.perf_counter() - t0:.1f} s")
    tc = cfg.train
    run_cfg = copy.deepcopy(cfg)
    run_cfg.train.update(data_dir=root, save_dir=os.path.join(root, "runs"),
                         num_epochs=DRIVER_EPOCHS, test_every=1)
    run_cfg.test.update(data_dir=root, save_dir=os.path.join(root, "test_out"))
    steps = DRIVER_UNLABELLED // tc.batch_size
    n_test = DRIVER_TEST

    # what the machine offers the driver: the decode path the Loader
    # takes, and the optional PIL and wandb
    from vq_seg_tpu_torch.data import fastimg

    def version(name):
        try:
            return __import__(name).__version__
        except ImportError:
            return "absent"

    decode = ("native C path (data/_fastimg.c on libpng and libdeflate)" if fastimg.load()
              else "PIL (the native decoder did not build)")
    print(f"[driver] image decode: {decode}; PIL {version('PIL')}; wandb "
          f"{version('wandb')} (WANDB_MODE=disabled here)")

    # the Loader alone: a cold (decoding) and a warm (cached) pass
    loader = Loader(BaseDataset(os.path.join(root, "train"), "unlabelled",
                                batch_size=tc.batch_size, resize=cfg.resize),
                    tc.batch_size, shuffle=True, workers=4)
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(b["img"].shape[0] for b in loader)
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    print(f"[driver] Loader, {DRIVER_UNLABELLED} images to the card (decode, resize to "
          f"{cfg.resize}, pinned non-blocking copy): cold {rates[0]:.1f} img/s, warm "
          f"{rates[1]:.1f} img/s | {card}")

    # the main path: train, then resume, then the sweep, then serve
    ckpoints.write_log.clear()
    history = []
    vq_cuda.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = train(run_cfg, history=history)
    launches_train = vq_cuda.launches
    ckpoints.wait_for_saves()
    scratch = [str(w.message) for w in caught if "FROM SCRATCH" in str(w.message)]
    check(len(scratch) == 1, f"expected one from-scratch warning, got {len(scratch)}")
    print(f"[driver] warning as expected: {scratch[0][:160]}...")
    expect = 6 + VQ_PER_STEP * steps * DRIVER_EPOCHS + 3 * n_test * DRIVER_EPOCHS
    check(launches_train == expect, f"train launched the kernel {launches_train} times, "
                                    f"expected {expect}")
    check([h["epoch"] for h in history] == list(range(DRIVER_EPOCHS)),
          f"epochs run {[h['epoch'] for h in history]}")
    for h in history:
        check(all(np.isfinite(h[k]) for k in LOSS_TERMS), f"non-finite losses {h}")
        check(0.0 <= h["miou"] <= 1.0 and 0.0 <= h["test_miou"] <= 1.0,
              f"epoch {h['epoch']}: miou {h['miou']}, test miou {h['test_miou']}")
    run_dir = os.path.join(root, "runs", f"{cfg.project_name}_hybrid_0")
    ck_dir = os.path.join(run_dir, "ckpoints")
    contract = {"model_1", "model_2", "epoch", "batch_idx", "optimizer_1", "optimizer_2"}
    for name in ("0ep.ckpt", "last.ckpt"):
        keys = set(ckpoints.load_full(os.path.join(ck_dir, name)))
        check(keys == contract, f"{name} keys {sorted(keys)}")
    cold, warm = history[0]["seconds"], history[-1]["seconds"]
    print(f"[driver] train: {DRIVER_EPOCHS} epochs x {steps} steps, bf16, batch "
          f"{tc.batch_size}+{tc.batch_size}, {launches_train} vq_assign launches (6 init + "
          f"{VQ_PER_STEP} per step + 3 per test image); epoch 0 (decoding, init phase) "
          f"{cold:.2f} s, epoch 1 (cached) {warm:.2f} s; driver {1e3 * warm / steps:.1f} "
          f"ms per step against the step alone's p50 {step_p50:.1f} ms (phase 6) | {card}")
    for h in history:
        print(f"[driver]   epoch {h['epoch']}: loss {h['loss']:.4f}, miou {h['miou']:.4f}, "
              f"test miou {h['test_miou']:.4f} (eval {h['eval_seconds']:.2f} s), lr "
              f"{h['lr']:.6g}, checkpoint host copy {h['ckpt_fetch_seconds']:.2f} s, "
              f"wrote {h['ckpt_files']}")
    for w in ckpoints.write_log:
        print(f"[driver]   checkpoint {os.path.basename(w['path'])}: {w['bytes']} bytes "
              f"({w['bytes'] / 2**30:.3f} GiB) written in {w['seconds']:.2f} s "
              f"(background thread) | {card}")

    # resume: one more epoch from the newest last.ckpt
    resume_cfg = copy.deepcopy(run_cfg)
    resume_cfg.train.update(resume="auto", num_epochs=DRIVER_EPOCHS + 1)
    history2 = []
    vq_cuda.launches = 0
    resumed = train(resume_cfg, history=history2)
    launches_resume = vq_cuda.launches
    ckpoints.wait_for_saves()
    schedule = make_lr_schedule(resume_cfg.train, steps)
    check([h["epoch"] for h in history2] == [DRIVER_EPOCHS],
          f"the resumed run ran epochs {[h['epoch'] for h in history2]}")
    h2 = history2[0]
    check(h2["step_start"] == steps * DRIVER_EPOCHS,
          f"resumed at step {h2['step_start']}, expected {steps * DRIVER_EPOCHS}")
    check(h2["lr_start"] == schedule(steps * DRIVER_EPOCHS),
          f"resumed lr {h2['lr_start']} != schedule({steps * DRIVER_EPOCHS})")
    expect = VQ_PER_STEP * steps + 3 * n_test
    check(launches_resume == expect, f"resumed run launched the kernel {launches_resume} "
                                     f"times, expected {expect}")
    check(all(np.isfinite(h2[k]) for k in LOSS_TERMS) and 0.0 <= h2["test_miou"] <= 1.0,
          f"resumed epoch {h2}")
    print(f"[driver] resume: epoch {h2['epoch']} only, from step {h2['step_start']} at lr "
          f"{h2['lr_start']:.6g} = schedule({h2['step_start']}); {launches_resume} vq_assign "
          f"launches; epoch {h2['seconds']:.2f} s (decoding again), loss {h2['loss']:.4f}, "
          f"test miou {h2['test_miou']:.4f} | {card}")
    del state, resumed

    # the test CLI's sweep over the first run's checkpoints
    sweep_cfg = copy.deepcopy(run_cfg)
    sweep_cfg.test.weights = ck_dir
    n_ckpts = len([n for n in os.listdir(ck_dir) if n.endswith(".ckpt")])
    vq_cuda.launches = 0
    t0 = time.perf_counter()
    best_path, best = test_cli.test(sweep_cfg)
    sweep_s = time.perf_counter() - t0
    launches_sweep = vq_cuda.launches
    check(launches_sweep == 3 * n_test * n_ckpts,
          f"sweep launched the kernel {launches_sweep} times, expected {3 * n_test * n_ckpts}")
    check(os.path.dirname(best_path) == ck_dir and 0.0 <= best["test_miou"] <= 1.0,
          f"sweep best {best_path} {best}")
    print(f"[driver] test CLI sweep of {n_ckpts} checkpoints x {n_test} images (f32, logits "
          f"resized to {DRIVER_WH[1]}x{DRIVER_WH[0]}): best {os.path.basename(best_path)} test miou "
          f"{best['test_miou']:.4f}, acc {best['test_acc']:.4f}; {launches_sweep} vq_assign "
          f"launches; {sweep_s:.1f} s | {card}")

    # serving from the run's last.ckpt
    pred = Predictor.from_checkpoint(cfg, os.path.join(ck_dir, "last.ckpt"),
                                     batch_size=tc.batch_size)
    imgs = np.random.default_rng(SEED + 2).integers(
        0, 256, (tc.batch_size, cfg.resize, cfg.resize, 3), dtype=np.uint8)
    vq_cuda.launches = 0
    labels = pred(imgs)
    launches_serve = vq_cuda.launches
    check(launches_serve == 3, f"served batch launched the kernel {launches_serve} times")
    check(labels.shape == imgs.shape[:3] and int(labels.max()) < int(cfg.num_classes),
          f"served labels {labels.shape}, max {int(labels.max())}")
    print(f"[driver] Predictor.from_checkpoint(last.ckpt): batch {tc.batch_size}, labels "
          f"{sorted(int(v) for v in np.unique(labels))}, {launches_serve} vq_assign launches")

    # the kernel at the evaluation forward's shapes (batch 1)
    captured = capture_vq_shapes(vector_quantizer,
                                 lambda: pred.logits(torch.from_numpy(imgs[:1]).cuda()))
    check(len(captured) == 3, f"captured {len(captured)} VQ calls of an eval forward")
    cases = []
    for i, (x, cb, metric) in enumerate(captured):
        r = compare_vq(f"eval-stage{3 + i}", x, cb, metric, vq_cuda, vq_assign_reference)
        cases.append(r)
        print(f"[driver-kernel] vq_assign {r['case']} N={r['n']} C={r['c']} K={r['k']}: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); near-tie rows {r['near_ties']} "
              f"| {card}")
    return {"launches": launches_train + launches_resume + launches_sweep + launches_serve,
            "launches_by_path": {"train": launches_train, "resume": launches_resume,
                                 "sweep": launches_sweep, "serve": launches_serve},
            "cases": cases}


def swap_vq_assign(vector_quantizer, fn):
    """Route the codebook stages' and the VQ head's ``vq_assign`` through
    ``fn``; returns the function that puts the dispatch back."""
    from vq_seg_tpu_torch.models.modules import heads

    dispatch = vector_quantizer.vq_assign
    vector_quantizer.vq_assign = heads.vq_assign = fn

    def restore():
        vector_quantizer.vq_assign = heads.vq_assign = dispatch

    return restore


def capture_vq_shapes(vector_quantizer, forward) -> list:
    """The (x, codebook, metric) of every VQ call that ``forward()`` makes."""
    dispatch = vector_quantizer.vq_assign
    captured = []

    def recording_vq_assign(x, codebook, metric="euclidean"):
        captured.append((x.detach().clone(), codebook.clone(), metric))
        return dispatch(x, codebook, metric)

    restore = swap_vq_assign(vector_quantizer, recording_vq_assign)
    try:
        forward()
    finally:
        restore()
    return captured


def timed_steps(run_step, n_warmup: int, n_timed: int, vq_cuda):
    """``run_step(i)`` for warm-up and timed steps, each ended by the loss
    fetch inside ``run_step``.  Returns (times ms of the timed steps, kernel
    launches per step, losses, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, per_step, losses = [], [], []
    for i in range(n_warmup + n_timed):
        n0 = vq_cuda.launches
        t0 = time.perf_counter()
        losses.append(run_step(i))
        dt = (time.perf_counter() - t0) * 1e3
        per_step.append(vq_cuda.launches - n0)
        if i >= n_warmup:
            times.append(dt)
    return times, per_step, losses, torch.cuda.max_memory_allocated()


def p50_p90(times):
    return (statistics.median(times),
            statistics.quantiles(times, n=10, method="inclusive")[-1])


def rept_phase(card: str, vq_cuda, vq_assign_reference, vector_quantizer, root: str) -> dict:
    """Phase 8: the ``reptcps`` family at full width (``vqreptunet1x1.json``:
    resnet50, K=512, 448x448, f32 as the JAX driver runs it), batch 4+4 at
    drop percent 80.  Returns the launches of each path and the timings."""
    import warnings

    from vq_seg_tpu_torch import load_config
    from vq_seg_tpu_torch.device import full_f32
    from vq_seg_tpu_torch.losses import make_loss
    from vq_seg_tpu_torch.models.modules import prototype
    from vq_seg_tpu_torch.training import (cps_init_phase, create_cps_state, make_lr_schedule,
                                           train_rept_cps, variants)
    from vq_seg_tpu_torch.utils import ckpoints

    cfg = load_config(REPT_CONFIG)
    hw, tc = int(cfg.resize), cfg.train
    n_steps = REPT_WARMUP + REPT_TIMED + REPT_PROFILED
    batches = train_batches(np.random.default_rng(SEED + 3), n_steps, hw)

    def make_step(c):
        crit = make_loss(c.train.criterion.name, int(c.num_classes), ignore_index=255,
                         weight=c.train.criterion.get("weight"))
        return variants.make_rept_cps_train_step(
            crit, num_classes=int(c.num_classes), cps_loss_weight=c.train.cps_loss_weight,
            commitment_loss_weight=c.train.total_commitment_loss_weight,
            prototype_loss_weight=c.train.total_prototype_loss_weight)

    def init(c):
        state = create_cps_state(c.model, make_lr_schedule(c.train, steps_per_epoch=n_steps),
                                 seed=SEED, encoder_weights=None)
        l_img, target, _ = batches[0]
        n0 = vq_cuda.launches
        with full_f32():  # as train_rept_cps runs it
            cps_init_phase(state, to_input(l_img), target, 100.0, seed=SEED)
        return state, vq_cuda.launches - n0

    print(f"[rept] {cfg.model.name} ({cfg.model.params.encoder_name}, num_embeddings "
          f"{list(cfg.model.params.vq_cfg.num_embeddings)}, margin {cfg.model.params.margin}), "
          f"{hw}x{hw}, batch {TRAIN_BATCH}+{TRAIN_BATCH}, f32, drop percent {REPT_DROP}, "
          f"criterion {tc.criterion.name}; random weights from seed {SEED}")
    vq_cuda.launches = 0
    state, init_launches = init(cfg)
    check(init_launches == 6, f"reptcps init phase launched the kernel {init_launches} times")
    post_init = copy.deepcopy(state)
    models = (state.model_1, state.model_2)
    before = [{k: v.detach().clone() for k, v in m.state_dict().items()} for m in models]
    step = make_step(cfg)
    tf32_seen = []
    hook = state.model_1.register_forward_pre_hook(lambda *_: tf32_seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))

    def run_step(i):
        l_img, target, ul_img = batches[i]
        _, metrics = step(state, to_input(l_img), target, to_input(ul_img), REPT_DROP)
        run_step.metrics = metrics
        return float(metrics["loss"])  # the step's one read of the card

    vq_cuda.launches = 0
    times, per_step, losses, peak = timed_steps(run_step, REPT_WARMUP, REPT_TIMED, vq_cuda)
    launches = vq_cuda.launches
    hook.remove()
    check(tf32_seen == [(False, False)] * 3 * (REPT_WARMUP + REPT_TIMED),
          f"TF32 flags seen by the reptcps forwards: {sorted(set(tf32_seen))}")
    check(torch.backends.cudnn.allow_tf32, "the reptcps step left cuDNN's TF32 flag changed")
    check(all(n == VQ_PER_STEP for n in per_step),
          f"reptcps launches per step {per_step}, expected {VQ_PER_STEP} each")
    check(all(np.isfinite(losses)), f"non-finite reptcps losses {losses}")
    metrics = run_step.metrics
    terms = {k: float(metrics[k]) for k in LOSS_TERMS}
    check(all(np.isfinite(list(terms.values()))), f"non-finite loss terms {terms}")
    for m, old, name in zip(models, before, ("model 1", "model 2")):
        sd = m.state_dict()
        moved = [k for k in dict(m.named_parameters()) if not torch.equal(sd[k], old[k])]
        # the detached prototype table gets no gradient and keeps its init
        frozen = [k for k in dict(m.named_parameters()) if k not in moved]
        check(frozen == ["prototype_loss.embedding"], f"{name}: parameters unchanged {frozen[:5]}")
        check(not [k for k in sd if "codebooks" in k and not torch.equal(sd[k], old[k])],
              f"{name}: codebooks changed by the steps")
    p50, p90 = p50_p90(times)
    print(f"[rept] init phase: {init_launches} vq_assign launches; {len(per_step)} steps "
          f"({REPT_WARMUP} warm-up), {launches} launches ({VQ_PER_STEP} per step); parameters "
          f"changed but the detached prototype tables, codebooks bitwise unchanged; TF32 off in "
          f"all {len(tf32_seen)} forwards of model 1 under PyTorch's default flags")
    print(f"[rept] f32 reptcps step, batch {TRAIN_BATCH}+{TRAIN_BATCH}, {hw}x{hw}: p50 "
          f"{p50:.3f} ms/step ({2 * TRAIN_BATCH * 1e3 / p50:.1f} img/s), p90 {p90:.3f} ms over "
          f"{REPT_TIMED} steps (min {min(times):.3f}, max {max(times):.3f}); peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) | {card}")
    print("[rept] last step: " + ", ".join(f"{k} {v:.6f}" for k, v in terms.items())
          + f", miou {float(metrics['miou']):.6f}")
    prof = profile_window(lambda i: run_step(REPT_WARMUP + REPT_TIMED + i), REPT_PROFILED,
                          "step", "rept-profile",
                          f"f32 reptcps step, batch {TRAIN_BATCH}+{TRAIN_BATCH}", card)
    del state, models, before

    # one f32 step from the post-init state, VQ on the kernel against VQ on
    # the plain version (near-tie rows given the kernel's code); the masks
    # of the entropy filters are recorded in both runs and compared
    recorded = []
    real_mask, real_pseudo = prototype.entropy_mask, variants.regularized_pseudo

    def mask(entropy, percent):
        recorded.append(real_mask(entropy, percent))
        return recorded[-1]

    def pseudo(pred, percent):
        out = real_pseudo(pred, percent)
        recorded.append(out == 255)
        return out

    step32 = make_step(cfg)
    l_img, target, ul_img = batches[1]
    prototype.entropy_mask, variants.regularized_pseudo = mask, pseudo
    try:
        loss_err, grad_err, worst, substituted = kernel_vs_plain_step(
            lambda st: step32(st, to_input(l_img), target, to_input(ul_img), REPT_DROP)[1],
            post_init, vq_cuda, vq_assign_reference, vector_quantizer)
    finally:
        prototype.entropy_mask, variants.regularized_pseudo = real_mask, real_pseudo
    masks = {"kernel": recorded[:len(recorded) // 2], "plain": recorded[len(recorded) // 2:]}
    check(len(masks["kernel"]) == len(masks["plain"]) == 6,
          f"entropy filters recorded {len(masks['kernel'])} / {len(masks['plain'])} times")
    flipped = [int((a != b).sum()) for a, b in zip(masks["kernel"], masks["plain"])]
    print(f"[rept-e2e] f32 reptcps step from the post-init state, VQ on the kernel vs on the "
          f"plain version: loss terms max relative difference {loss_err:.3e} (limit "
          f"{STEP_LOSS_TOL}), gradients max relative L2 {grad_err:.3e} at {worst} (limit "
          f"{STEP_GRAD_TOL}); near-tie rows given the kernel's code per VQ call: {substituted}; "
          f"pixels on which the percentile masks disagree (4 prototype filters, 2 pseudo-label "
          f"filters): {flipped}")
    check(len(substituted) == VQ_PER_STEP, f"plain step made {len(substituted)} VQ calls")
    check(loss_err <= STEP_LOSS_TOL, f"f32 reptcps loss terms differ by {loss_err}")
    check(grad_err <= STEP_GRAD_TOL, f"f32 reptcps gradient of {worst} differs by {grad_err}")
    del post_init
    torch.cuda.empty_cache()

    # one step of each sibling network
    siblings = {}
    for name in REPT_SIBLINGS:
        c = load_config(os.path.join(ROOT, "config", f"{name}.json"))
        vq_cuda.launches = 0
        st, n_init = init(c)
        sib_step = make_step(c)
        l_img, target, ul_img = batches[2]
        n0 = vq_cuda.launches
        t0 = time.perf_counter()
        _, m = sib_step(st, to_input(l_img), target, to_input(ul_img), REPT_DROP)
        sib_terms = {k: float(m[k]) for k in LOSS_TERMS}
        ms = (time.perf_counter() - t0) * 1e3
        n_step = vq_cuda.launches - n0
        check(n_init == 6 and n_step == VQ_PER_STEP,
              f"{name}: {n_init} launches at init, {n_step} in the step")
        check(all(np.isfinite(list(sib_terms.values()))), f"{name}: loss terms {sib_terms}")
        siblings[name] = n_init + n_step
        print(f"[rept] {name} ({c.model.name}): init {n_init} + step {n_step} vq_assign launches, "
              f"first step {ms:.1f} ms; " + ", ".join(f"{k} {v:.5f}" for k, v in sib_terms.items()))
        del st
        torch.cuda.empty_cache()

    # the driver on phase 7's tree
    run_cfg = copy.deepcopy(cfg)
    run_cfg.train.update(data_dir=root, save_dir=os.path.join(root, "runs_reptcps"),
                         num_epochs=VARIANT_DRIVER_EPOCHS, test_every=1)
    run_cfg.test.update(data_dir=root, save_dir=os.path.join(root, "test_reptcps"))
    steps = DRIVER_UNLABELLED // tc.batch_size
    history = []
    vq_cuda.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        train_rept_cps(run_cfg, history=history)
    driver_s = time.perf_counter() - t0
    launches_driver = vq_cuda.launches
    check(sum("FROM SCRATCH" in str(w.message) for w in caught) == 1,
          "expected one from-scratch warning from the reptcps driver")
    epochs = VARIANT_DRIVER_EPOCHS
    expect = 6 + VQ_PER_STEP * steps * epochs + 3 * DRIVER_TEST * epochs
    check(launches_driver == expect,
          f"train_rept_cps launched the kernel {launches_driver} times, expected {expect}")
    check([h["epoch"] for h in history] == list(range(epochs)), f"epochs {history}")
    for h in history:
        check(all(np.isfinite(h[k]) for k in LOSS_TERMS) and 0.0 <= h["test_miou"] <= 1.0,
              f"reptcps epoch {h}")
    ck_dir = os.path.join(root, "runs_reptcps", f"{cfg.project_name}_reptcps_0", "ckpoints")
    contract = {"model_1", "model_2", "epoch", "batch_idx", "optimizer_1", "optimizer_2"}
    for name in ("0ep.ckpt", "last.ckpt"):
        keys = set(ckpoints.load_full(os.path.join(ck_dir, name)))
        check(keys == contract, f"reptcps {name} keys {sorted(keys)}")
    print(f"[rept-driver] train_rept_cps: {epochs} epochs x {steps} steps, f32, batch "
          f"{tc.batch_size}+{tc.batch_size}, drop percent "
          f"{[h['drop_percent'] for h in history]}, {launches_driver} vq_assign launches (6 init "
          f"+ {VQ_PER_STEP} per step + 3 per test image); epochs "
          f"{[round(h['seconds'], 2) for h in history]} s, test miou "
          f"{[round(h['test_miou'], 4) for h in history]}; {driver_s:.1f} s in all | {card}")
    return {"launches": launches, "init_launches": init_launches,
            "vq_ms": prof["vq_ms"] if prof else None,
            "device_ms": prof["device_ms"] if prof else None, "siblings": siblings,
            "driver_launches": launches_driver}


def sup_phase(card: str, vq_cuda, vq_assign_reference, vector_quantizer, root: str) -> dict:
    """Phase 9: the supervised baseline at full width, bf16 as the configs
    set it: ``only_sup_kmeans.json`` (``vqunet_v2``, batch 4) and
    ``CWFID_Unet.json`` (``unet``, batch 8), then the sup driver for one
    epoch on phase 7's tree.  Returns the launches and timings."""
    from vq_seg_tpu_torch import load_config
    from vq_seg_tpu_torch.losses import make_loss
    from vq_seg_tpu_torch.training import make_lr_schedule, supervised
    from vq_seg_tpu_torch.utils import ckpoints

    out = {}
    for name, per_step_expect in SUP_CONFIGS:
        cfg = load_config(os.path.join(ROOT, "config", f"{name}.json"))
        hw, tc = int(cfg.resize), cfg.train
        half = bool(tc.half)
        n_steps = SUP_WARMUP + SUP_TIMED + SUP_PROFILED
        batches = train_batches(np.random.default_rng(SEED + 4), n_steps, hw, tc.batch_size)
        state = supervised.create_state(cfg.model, make_lr_schedule(tc, steps_per_epoch=n_steps),
                                        seed=SEED)
        mode = supervised.sup_forward_mode(cfg.model.name)
        dice = make_loss(tc.criterion.name, int(cfg.num_classes), ignore_index=255,
                         weight=tc.criterion.get("weight"))
        step = supervised.make_sup_train_step(dice, num_classes=int(cfg.num_classes),
                                              forward_mode=mode, half=half)
        l_img, target, _ = batches[0]
        vq_cuda.launches = 0
        supervised.init_phase(state, supervised.forward_args(mode, to_input(l_img), target, 100.0),
                              seed=SEED, half=half)
        init_launches = vq_cuda.launches
        expect_init = 3 if per_step_expect else 0
        check(init_launches == expect_init,
              f"{name}: init phase launched the kernel {init_launches} times, not {expect_init}")

        def run_step(i):
            l_img, target, _ = batches[i]
            _, metrics, _ = step(state, to_input(l_img), target, 100.0)
            run_step.metrics = metrics
            return float(metrics["loss"])

        vq_cuda.launches = 0
        times, per_step, losses, peak = timed_steps(run_step, SUP_WARMUP, SUP_TIMED, vq_cuda)
        launches = vq_cuda.launches
        check(all(n == per_step_expect for n in per_step),
              f"{name}: launches per step {per_step}, expected {per_step_expect}")
        check(all(np.isfinite(losses)), f"{name}: non-finite losses {losses}")
        p50, p90 = p50_p90(times)
        batch = tc.batch_size
        print(f"[sup] {name} ({cfg.model.name}, {cfg.model.params.encoder_name}, {hw}x{hw}, batch "
              f"{batch}, {'bf16 autocast' if half else 'f32'}): init {init_launches} + "
              f"{launches} vq_assign launches ({per_step_expect} per step); p50 "
              f"{p50:.3f} ms/step ({batch * 1e3 / p50:.1f} img/s), p90 {p90:.3f} ms over "
              f"{SUP_TIMED} steps; peak memory {peak / 2**30:.2f} GiB; last loss {losses[-1]:.5f}, "
              f"code_usage {float(run_step.metrics['code_usage']):.3f} | {card}")
        profile_window(lambda i: run_step(SUP_WARMUP + SUP_TIMED + i), SUP_PROFILED, "step",
                       f"sup-profile {name}", f"bf16 sup step, batch {batch}", card)
        cases = []
        if per_step_expect:
            # the kernel at the shapes of a sup train pass
            probe = copy.deepcopy(state.model).train()

            def sup_pass():
                with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16, enabled=half):
                    probe(to_input(batches[1][0]), train=True)

            captured = capture_vq_shapes(vector_quantizer, sup_pass)
            del probe
            check(len(captured) == 3, f"captured {len(captured)} VQ calls of a sup pass")
            for i, (x, cb, metric) in enumerate(captured):
                r = compare_vq(f"sup-stage{3 + i}", x, cb, metric, vq_cuda, vq_assign_reference)
                cases.append(r)
                print(f"[sup-kernel] vq_assign {r['case']} N={r['n']} C={r['c']} K={r['k']}: "
                      f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']}); near-tie rows {r['near_ties']} "
                      f"(max f64 score gap {r['max_abs_err']:.3e}) | {card}")
        out[name] = {"init_launches": init_launches, "launches": launches, "cases": cases}
        del state, batches
        torch.cuda.empty_cache()

    # the sup driver for one epoch on the tree
    cfg = load_config(os.path.join(ROOT, "config", f"{SUP_CONFIGS[0][0]}.json"))
    cfg.train.update(data_dir=root, save_dir=os.path.join(root, "runs_sup"), num_epochs=1)
    steps = -(-DRIVER_LABELLED // cfg.train.batch_size)
    history = []
    vq_cuda.launches = 0
    supervised.train(cfg, history=history)
    launches_driver = vq_cuda.launches
    check(launches_driver == 3 + 3 * steps,
          f"sup driver launched the kernel {launches_driver} times, expected {3 + 3 * steps}")
    [h] = history
    check(np.isfinite(h["loss"]) and 0.0 <= h["miou"] <= 1.0, f"sup epoch {h}")
    last = os.path.join(root, "runs_sup", f"{cfg.project_name}_sup_0", "ckpoints", "last.ckpt")
    keys = set(ckpoints.load_full(last))
    check(keys == {"model_1", "epoch"}, f"sup last.ckpt keys {sorted(keys)}")
    print(f"[sup-driver] train ({SUP_CONFIGS[0][0]}): 1 epoch x {steps} steps, bf16, "
          f"{launches_driver} vq_assign launches (3 init + 3 per step), loss {h['loss']:.4f}, "
          f"{h['seconds']:.2f} s; last.ckpt keys {sorted(keys)} | {card}")
    out["driver_launches"] = launches_driver
    return out


def plain_phase(card: str, vq_cuda, vq_assign_reference, vector_quantizer, root: str) -> dict:
    """Phase 10: ``plaincps`` and ``objcps`` with the attention networks at
    full width, f32 as the JAX drivers run them.  Returns the launches of
    each path, the timings and the kernel's cases at the new shapes."""
    import warnings

    from vq_seg_tpu_torch import load_config
    from vq_seg_tpu_torch import test as test_cli
    from vq_seg_tpu_torch.device import full_f32
    from vq_seg_tpu_torch.serving import Predictor
    from vq_seg_tpu_torch.training import (create_cps_state, make_lr_schedule, plain_init_phase,
                                           plain_step, train_obj_cps, train_plain_cps)
    from vq_seg_tpu_torch.training.cps import model_cfg_with_bn
    from vq_seg_tpu_torch.utils import ckpoints

    contract = {"model_1", "model_2", "epoch", "batch_idx", "optimizer_1", "optimizer_2"}
    batches_for = batch_cache(SEED + 5)

    def init(c, n_steps, batch):
        """The drivers' state, step and init phase (random weights from
        SEED); returns (state, step, the init phase's launches)."""
        check(c.train.batch_size == TRAIN_BATCH,
              f"batch size {c.train.batch_size}, the batches hold {TRAIN_BATCH}")
        state = create_cps_state(model_cfg_with_bn(c), make_lr_schedule(c.train, n_steps),
                                 seed=SEED, encoder_weights=None)
        step = plain_step(c, state, c.mode)
        l_img, target, _ = batch
        n0 = vq_cuda.launches
        with full_f32():  # as the drivers run it
            plain_init_phase(state, to_input(l_img), target)
        return state, step, vq_cuda.launches - n0

    out = {"configs": {}, "cases": []}
    for name, mode, warmup, timed, profiled, terms in (
            (PLAIN_CONFIG, "plaincps", PLAIN_WARMUP, PLAIN_TIMED, PLAIN_PROFILED, PLAIN_TERMS),
            (OBJ_CONFIG, "objcps", OBJ_WARMUP, OBJ_TIMED, 0, OBJ_TERMS)):
        cfg = load_config(os.path.join(ROOT, "config", f"{name}.json"))
        hw = int(cfg.resize)
        n_steps = warmup + timed + profiled
        batches = batches_for(hw, n_steps + 2)
        per_fwd = PLAIN_CONFIGS[name]
        print(f"[{mode}] {name}: {cfg.model.name} ({cfg.model.params.encoder_name}, "
              f"num_embeddings {list(cfg.model.params.vq_cfg.num_embeddings)}), {hw}x{hw}, batch "
              f"{TRAIN_BATCH}+{TRAIN_BATCH}, f32, criterion {cfg.train.criterion.name}; random "
              f"weights from seed {SEED}")
        check(cfg.mode == mode, f"{name}: mode {cfg.mode}, expected {mode}")
        vq_cuda.launches = 0
        state, step, init_launches = init(cfg, n_steps, batches[0])
        check(init_launches == 2 * per_fwd,
              f"{mode} init phase launched the kernel {init_launches} times, not {2 * per_fwd}")
        post_init = copy.deepcopy(state)
        models = (state.model_1, state.model_2)
        before = [{k: v.detach().clone() for k, v in m.state_dict().items()} for m in models]
        tf32_seen = []
        hook = state.model_1.register_forward_pre_hook(lambda *_: tf32_seen.append(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
        run_step = step_runner(step, state, batches)
        vq_cuda.launches = 0
        times, per_step, losses, peak = timed_steps(run_step, warmup, timed, vq_cuda)
        launches = vq_cuda.launches
        hook.remove()
        check(tf32_seen == [(False, False)] * 2 * (warmup + timed),
              f"TF32 flags seen by the {mode} forwards: {sorted(set(tf32_seen))}")
        check(all(n == 4 * per_fwd for n in per_step),
              f"{mode} launches per step {per_step}, expected {4 * per_fwd} each")
        check(all(np.isfinite(losses)), f"non-finite {mode} losses {losses}")
        step_terms = {k: float(run_step.metrics[k]) for k in terms}
        check(all(np.isfinite(list(step_terms.values()))), f"non-finite loss terms {step_terms}")
        for m, old, label in zip(models, before, ("model 1", "model 2")):
            sd = m.state_dict()
            frozen = [k for k in dict(m.named_parameters()) if torch.equal(sd[k], old[k])]
            check(not frozen, f"{label}: parameters unchanged {frozen[:5]}")
            check(not [k for k in sd if "codebooks" in k and not torch.equal(sd[k], old[k])],
                  f"{label}: codebooks changed by the steps")
        p50, p90 = p50_p90(times)
        print(f"[{mode}] init phase: {init_launches} vq_assign launches; {len(per_step)} steps "
              f"({warmup} warm-up), {launches} launches ({4 * per_fwd} per step); every "
              f"parameter changed, codebooks bitwise unchanged; TF32 off in all "
              f"{len(tf32_seen)} forwards of model 1 under PyTorch's default flags")
        print(f"[{mode}] f32 {mode} step, batch {TRAIN_BATCH}+{TRAIN_BATCH}, {hw}x{hw}: p50 "
              f"{p50:.3f} ms/step ({2 * TRAIN_BATCH * 1e3 / p50:.1f} img/s), p90 {p90:.3f} ms over "
              f"{timed} steps (min {min(times):.3f}, max {max(times):.3f}); peak memory "
              f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) | {card}")
        print(f"[{mode}] last step: " + ", ".join(f"{k} {v:.6f}" for k, v in step_terms.items())
              + f", miou {float(run_step.metrics['miou']):.6f}")
        prof = None
        if profiled:
            prof = profile_window(lambda i: run_step(warmup + timed + i), profiled, "step",
                                  f"{mode}-profile",
                                  f"f32 {mode} step, batch {TRAIN_BATCH}+{TRAIN_BATCH}", card)
        if mode == "plaincps":
            # the kernel at the three shapes of a train pass
            probe = copy.deepcopy(state.model_1).train()

            def train_pass():
                with torch.no_grad(), full_f32():
                    probe(to_input(batches[1][0]), train=True)

            for i, (x, cb, metric) in enumerate(capture_vq_shapes(vector_quantizer, train_pass)):
                r = compare_vq(f"{name}-stage{3 + i}", x, cb, metric, vq_cuda, vq_assign_reference)
                out["cases"].append(r)
            del probe
        del state, models, before
        # one f32 step from the post-init state, VQ on the kernel against VQ
        # on the plain version (near-tie rows given the kernel's code)
        l_img, target, ul_img = batches[1]
        loss_err, grad_err, worst, substituted = kernel_vs_plain_step(
            lambda st: step(st, to_input(l_img), target, to_input(ul_img))[1],
            post_init, vq_cuda, vq_assign_reference, vector_quantizer, terms)
        print(f"[{mode}-e2e] f32 {mode} step from the post-init state, VQ on the kernel vs on "
              f"the plain version: loss terms max relative difference {loss_err:.3e} (limit "
              f"{STEP_LOSS_TOL}), gradients max relative L2 {grad_err:.3e} at {worst} (limit "
              f"{STEP_GRAD_TOL}); near-tie rows given the kernel's code per VQ call: "
              f"{substituted}")
        check(len(substituted) == 4 * per_fwd, f"plain step made {len(substituted)} VQ calls")
        check(loss_err <= STEP_LOSS_TOL, f"f32 {mode} loss terms differ by {loss_err}")
        check(grad_err <= STEP_GRAD_TOL, f"f32 {mode} gradient of {worst} differs by {grad_err}")
        del post_init
        torch.cuda.empty_cache()
        out[mode] = {"init_launches": init_launches, "launches": launches, "per_step": per_step,
                     "p50": p50,
                     "peak_gib": peak / 2**30,
                     "vq_ms": prof["vq_ms"] if prof else None,
                     "device_ms": prof["device_ms"] if prof else None}

    # one step of each shipped config at its own width and resize
    for name, per_fwd in PLAIN_CONFIGS.items():
        c = load_config(os.path.join(ROOT, "config", f"{name}.json"))
        mode = "objcps" if name in OBJ_CONFIGS else "plaincps"
        check(c.mode == mode, f"{name}: mode {c.mode}, expected {mode}")
        hw = int(c.resize)
        batches = batches_for(hw, 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        vq_cuda.launches = 0
        st, cfg_step, n_init = init(c, 1, batches[0])
        l_img, target, ul_img = batches[2]
        n0 = vq_cuda.launches
        t0 = time.perf_counter()
        _, m = cfg_step(st, to_input(l_img), target, to_input(ul_img))
        step_terms = {k: float(m[k]) for k in (OBJ_TERMS if mode == "objcps" else PLAIN_TERMS)}
        ms = (time.perf_counter() - t0) * 1e3
        n_step = vq_cuda.launches - n0
        peak = torch.cuda.max_memory_allocated()
        check(n_init == 2 * per_fwd and n_step == 4 * per_fwd,
              f"{name}: {n_init} launches at init, {n_step} in the step; expected "
              f"{2 * per_fwd} and {4 * per_fwd}")
        check(all(np.isfinite(list(step_terms.values()))), f"{name}: loss terms {step_terms}")
        out["configs"][name] = {"init": n_init, "step": n_step, "peak_gib": peak / 2**30,
                                "first_step_ms": ms}
        print(f"[{mode}-configs] {name} ({c.model.name}, {c.model.params.encoder_name}, {hw}x{hw}, "
              f"batch {TRAIN_BATCH}+{TRAIN_BATCH}): init {n_init} + step {n_step} vq_assign "
              f"launches, first step {ms:.1f} ms, peak memory {peak / 2**30:.2f} GiB; "
              + ", ".join(f"{k} {v:.5f}" for k, v in step_terms.items()) + f" | {card}")
        if name in NEW_SHAPE_CONFIGS:
            probe = st.model_1.train()

            def train_pass():
                with torch.no_grad(), full_f32():
                    probe(to_input(batches[1][0]), train=True)

            for i, (x, cb, metric) in enumerate(capture_vq_shapes(vector_quantizer, train_pass)):
                label = "head" if cb.shape[0] == 3 else f"vq{i}"
                r = compare_vq(f"{name}-{label}", x, cb, metric, vq_cuda, vq_assign_reference)
                out["cases"].append(r)
        del st
        torch.cuda.empty_cache()

    # K = 3 and a code range split over the grid: tiles of one partly
    # filled block of codes, the zero-filled columns of a 3-code tile
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for label, (n, c, k) in (("k3-small", (1000, 32, 3)), ("k130-split", (2048, 64, 130))):
        out["cases"].append(compare_vq(label, torch.randn(n, c, device="cuda", generator=g),
                                       torch.randn(k, c, device="cuda", generator=g),
                                       "euclidean", vq_cuda, vq_assign_reference))
    for r in out["cases"]:
        print(f"[plain-kernel] vq_assign {r['case']} N={r['n']} C={r['c']} K={r['k']}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; f32 SIMT bound {r['f32_simt_bound_ms']:.4f}); near-tie rows "
              f"{r['near_ties']} (max f64 score gap {r['max_abs_err']:.3e}) | {card}")

    # the drivers on phase 7's tree, one epoch each
    test_imgs = DRIVER_TEST
    for name, mode, train_fn, epochs in ((PLAIN_CONFIG, "plaincps", train_plain_cps,
                                          VARIANT_DRIVER_EPOCHS),
                                         (OBJ_CONFIG, "objcps", train_obj_cps, 1)):
        cfg = load_config(os.path.join(ROOT, "config", f"{name}.json"))
        cfg.train.update(data_dir=root, save_dir=os.path.join(root, f"runs_{mode}"),
                         num_epochs=epochs, test_every=1)
        cfg.test.update(data_dir=root, save_dir=os.path.join(root, f"test_{mode}"))
        steps = DRIVER_UNLABELLED // cfg.train.batch_size
        history = []
        vq_cuda.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            train_fn(cfg, history=history)
        driver_s = time.perf_counter() - t0
        launches_driver = vq_cuda.launches
        check(sum("FROM SCRATCH" in str(w.message) for w in caught) == 1,
              f"expected one from-scratch warning from the {mode} driver")
        expect = 6 + 12 * steps * epochs + 3 * test_imgs * epochs
        check(launches_driver == expect,
              f"{mode} driver launched the kernel {launches_driver} times, expected {expect}")
        check([h["epoch"] for h in history] == list(range(epochs)), f"epochs {history}")
        terms = OBJ_TERMS if mode == "objcps" else PLAIN_TERMS
        for h in history:
            check(all(np.isfinite(h[k]) for k in terms) and 0.0 <= h["test_miou"] <= 1.0,
                  f"{mode} epoch {h}")
        ck_dir = os.path.join(root, f"runs_{mode}", f"{cfg.project_name}_{mode}_0", "ckpoints")
        names = sorted(n for n in os.listdir(ck_dir) if n.endswith(".ckpt"))
        check(names == ["0ep.ckpt", "last.ckpt"], f"{mode} checkpoints {names}")
        for n_ck in names:
            keys = set(ckpoints.load_full(os.path.join(ck_dir, n_ck)))
            check(keys == contract, f"{mode} {n_ck} keys {sorted(keys)}")
        print(f"[{mode}-driver] {train_fn.__name__}: {epochs} epochs x {steps} steps, f32, batch "
              f"{cfg.train.batch_size}+{cfg.train.batch_size}, {launches_driver} vq_assign "
              f"launches (6 init + 12 per step + 3 per test image); epochs "
              f"{[round(h['seconds'], 2) for h in history]} s, loss "
              f"{[round(h['loss'], 4) for h in history]}, test miou "
              f"{[round(h['test_miou'], 4) for h in history]}; {driver_s:.1f} s in all | {card}")
        out[f"{mode}_driver"] = launches_driver
        if mode != "plaincps":
            continue
        # the test CLI's sweep of the run, and serving from its last.ckpt
        sweep_cfg = copy.deepcopy(cfg)
        sweep_cfg.test.weights = ck_dir
        vq_cuda.launches = 0
        t0 = time.perf_counter()
        best_path, best = test_cli.test(sweep_cfg)
        sweep_s = time.perf_counter() - t0
        out["plaincps_sweep"] = vq_cuda.launches
        check(out["plaincps_sweep"] == 3 * test_imgs * len(names),
              f"sweep launched the kernel {out['plaincps_sweep']} times")
        check(0.0 <= best["test_miou"] <= 1.0, f"sweep best {best_path} {best}")
        pred = Predictor.from_checkpoint(cfg, os.path.join(ck_dir, "last.ckpt"),
                                         batch_size=cfg.train.batch_size)
        imgs = np.random.default_rng(SEED + 6).integers(
            0, 256, (cfg.train.batch_size, cfg.resize, cfg.resize, 3), dtype=np.uint8)
        vq_cuda.launches = 0
        labels = pred(imgs)
        out["plaincps_serve"] = vq_cuda.launches
        check(out["plaincps_serve"] == 3, f"served batch launched {out['plaincps_serve']}")
        check(labels.shape == imgs.shape[:3] and int(labels.max()) < int(cfg.num_classes),
              f"served labels {labels.shape}, max {int(labels.max())}")
        print(f"[plaincps-driver] test CLI sweep of {len(names)} checkpoints x {test_imgs} "
              f"images: best {os.path.basename(best_path)} test miou {best['test_miou']:.4f}, "
              f"{out['plaincps_sweep']} vq_assign launches, {sweep_s:.1f} s; "
              f"Predictor.from_checkpoint(last.ckpt): batch {cfg.train.batch_size}, labels "
              f"{sorted(int(v) for v in np.unique(labels))}, {out['plaincps_serve']} launches "
              f"| {card}")
        del pred
        torch.cuda.empty_cache()
    return out


def vqpt_phase(card: str, vq_cuda, vq_assign_reference, vector_quantizer, root: str) -> dict:
    """Phase 11: ``vqpt`` and ``easyhard`` with the (x, gt) networks at full
    width, f32 as the JAX drivers run them.  Returns the launches of each
    path and the timings."""
    import warnings

    from vq_seg_tpu_torch import load_config
    from vq_seg_tpu_torch import test as test_cli
    from vq_seg_tpu_torch.device import full_f32
    from vq_seg_tpu_torch.serving import Predictor
    from vq_seg_tpu_torch.training import (create_cps_state, easyhard_draws, make_lr_schedule,
                                           train_easyhard_cps, train_vqpt_cps, vqpt_init_phase,
                                           vqpt_step)
    from vq_seg_tpu_torch.training.cps import model_cfg_with_bn
    from vq_seg_tpu_torch.utils import ckpoints

    contract = {"model_1", "model_2", "epoch", "batch_idx", "optimizer_1", "optimizer_2"}
    batches_for = batch_cache(SEED + 8)

    def per_forward(c) -> int:
        """VQ launches per forward: the stages with a codebook."""
        return sum(1 for k in c.model.params.vq_cfg.num_embeddings if k)

    def init(c, n_steps, batch):
        """The drivers' state and step and the init phase (random weights
        from SEED); returns (state, step, the init phase's launches).  The
        easyhard step draws its mask and flip as the driver does; its
        ``raw`` takes them as arguments."""
        check(c.train.batch_size == TRAIN_BATCH,
              f"batch size {c.train.batch_size}, the batches hold {TRAIN_BATCH}")
        state = create_cps_state(model_cfg_with_bn(c), make_lr_schedule(c.train, n_steps),
                                 seed=SEED, encoder_weights=None)
        step = vqpt_step(c, c.mode)
        if c.mode == "easyhard":
            draw, raw = easyhard_draws(c, "cuda"), step

            def step(state, l_img, l_target, ul_img):
                return raw(state, l_img, l_target, ul_img, *draw(ul_img.shape[-2:]))

            step.raw = raw
        l_img, target, _ = batch
        n0 = vq_cuda.launches
        with full_f32():  # as the drivers run it
            vqpt_init_phase(state, to_input(l_img), target)
        return state, step, vq_cuda.launches - n0

    out = {"configs": {}}
    for name, warmup, timed, profiled, terms in (
            (VQPT_CONFIG, VQPT_WARMUP, VQPT_TIMED, VQPT_PROFILED, LOSS_TERMS),
            (EASYHARD_CONFIG, EASYHARD_WARMUP, EASYHARD_TIMED, 0, EASYHARD_TERMS)):
        cfg = load_config(os.path.join(ROOT, "config", f"{name}.json"))
        mode, hw = cfg.mode, int(cfg.resize)
        per_step = 6 * per_forward(cfg)  # 2 pseudo + 4 train forwards
        n_steps = warmup + timed + profiled
        batches = batches_for(hw, n_steps + 2)
        print(f"[{mode}] {name}: {cfg.model.name} ({cfg.model.params.encoder_name}, "
              f"num_embeddings {list(cfg.model.params.vq_cfg.num_embeddings)}), {hw}x{hw}, batch "
              f"{TRAIN_BATCH}+{TRAIN_BATCH}, f32, criterion {cfg.train.criterion.name}; random "
              f"weights from seed {SEED}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        vq_cuda.launches = 0
        state, step, init_launches = init(cfg, n_steps, batches[0])
        check(init_launches == 2 * per_forward(cfg),
              f"{mode} init phase launched the kernel {init_launches} times")
        post_init = copy.deepcopy(state)
        models = (state.model_1, state.model_2)
        before = [{k: v.detach().clone() for k, v in m.state_dict().items()} for m in models]
        tf32_seen = []
        hook = state.model_1.register_forward_pre_hook(lambda *_: tf32_seen.append(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
        run_step = step_runner(step, state, batches)
        vq_cuda.launches = 0
        times, launches_per_step, losses, peak = timed_steps(run_step, warmup, timed, vq_cuda)
        launches = vq_cuda.launches
        hook.remove()
        check(tf32_seen == [(False, False)] * 3 * (warmup + timed),
              f"TF32 flags seen by the {mode} forwards: {sorted(set(tf32_seen))}")
        check(all(n == per_step for n in launches_per_step),
              f"{mode} launches per step {launches_per_step}, expected {per_step} each")
        check(all(np.isfinite(losses)), f"non-finite {mode} losses {losses}")
        step_terms = {k: float(run_step.metrics[k]) for k in terms}
        check(all(np.isfinite(list(step_terms.values()))), f"non-finite loss terms {step_terms}")
        for m, old, label in zip(models, before, ("model 1", "model 2")):
            sd = m.state_dict()
            frozen = [k for k in dict(m.named_parameters()) if torch.equal(sd[k], old[k])]
            # PrototypeLoss's detached table gets no gradient
            check(frozen == ["prototype_loss.embedding"],
                  f"{label}: parameters unchanged {frozen[:5]}")
            check(not [k for k in sd if "codebooks" in k and not torch.equal(sd[k], old[k])],
                  f"{label}: codebooks changed by the steps")
        p50, p90 = p50_p90(times)
        print(f"[{mode}] init phase: {init_launches} vq_assign launches; {len(launches_per_step)} "
              f"steps ({warmup} warm-up), {launches} launches ({per_step} per step); parameters "
              f"changed but the detached prototype tables, codebooks bitwise unchanged; TF32 off "
              f"in all {len(tf32_seen)} forwards of model 1 under PyTorch's default flags")
        print(f"[{mode}] f32 {mode} step, batch {TRAIN_BATCH}+{TRAIN_BATCH}, {hw}x{hw}: p50 "
              f"{p50:.3f} ms/step ({2 * TRAIN_BATCH * 1e3 / p50:.1f} img/s), p90 {p90:.3f} ms over "
              f"{timed} steps (min {min(times):.3f}, max {max(times):.3f}); peak memory "
              f"{peak / 2**30:.2f} GiB from the init on (torch.cuda.max_memory_allocated) | {card}")
        print(f"[{mode}] last step: " + ", ".join(f"{k} {v:.6f}" for k, v in step_terms.items())
              + f", miou {float(run_step.metrics['miou']):.6f}")
        prof = None
        if profiled:
            prof = profile_window(lambda i: run_step(warmup + timed + i), profiled, "step",
                                  f"{mode}-profile",
                                  f"f32 {mode} step, batch {TRAIN_BATCH}+{TRAIN_BATCH}", card)
        del state, models, before
        # one f32 step from the post-init state, VQ on the kernel against VQ
        # on the plain version (near-tie rows given the kernel's code); the
        # easyhard step with one fixed box and a width flip in both runs
        l_img, target, ul_img = batches[1]
        if mode == "easyhard":
            mask, _ = easyhard_draws(cfg, "cuda")((hw, hw))
            run = lambda st: step.raw(st, to_input(l_img), target, to_input(ul_img), mask, 1)[1]
        else:
            run = lambda st: step(st, to_input(l_img), target, to_input(ul_img))[1]
        loss_err, grad_err, worst, substituted = kernel_vs_plain_step(
            run, post_init, vq_cuda, vq_assign_reference, vector_quantizer, terms)
        print(f"[{mode}-e2e] f32 {mode} step from the post-init state, VQ on the kernel vs on "
              f"the plain version: loss terms max relative difference {loss_err:.3e} (limit "
              f"{STEP_LOSS_TOL}), gradients max relative L2 {grad_err:.3e} at {worst} (limit "
              f"{STEP_GRAD_TOL}); near-tie rows given the kernel's code per VQ call: "
              f"{substituted}")
        check(len(substituted) == per_step, f"plain step made {len(substituted)} VQ calls")
        check(loss_err <= STEP_LOSS_TOL, f"f32 {mode} loss terms differ by {loss_err}")
        check(grad_err <= STEP_GRAD_TOL, f"f32 {mode} gradient of {worst} differs by {grad_err}")
        del post_init
        torch.cuda.empty_cache()
        out[mode] = {"init_launches": init_launches, "launches": launches,
                     "per_step": launches_per_step, "p50": p50, "peak_gib": peak / 2**30,
                     "vq_ms": prof["vq_ms"] if prof else None,
                     "device_ms": prof["device_ms"] if prof else None}
        out["configs"][name] = {"init": init_launches, "step": launches_per_step[0],
                                "peak_gib": peak / 2**30}

    # one step of each other shipped config at its own width and resize
    for name in VQPT_CONFIGS:
        c = load_config(os.path.join(ROOT, "config", f"{name}.json"))
        check(c.mode == "vqpt", f"{name}: mode {c.mode}, expected vqpt")
        hw, per_fwd = int(c.resize), per_forward(c)
        batches = batches_for(hw, 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        vq_cuda.launches = 0
        st, cfg_step, n_init = init(c, 1, batches[0])
        l_img, target, ul_img = batches[2]
        n0 = vq_cuda.launches
        t0 = time.perf_counter()
        _, m = cfg_step(st, to_input(l_img), target, to_input(ul_img))
        step_terms = {k: float(m[k]) for k in LOSS_TERMS}
        ms = (time.perf_counter() - t0) * 1e3
        n_step = vq_cuda.launches - n0
        peak = torch.cuda.max_memory_allocated()
        check(n_init == 2 * per_fwd and n_step == 6 * per_fwd,
              f"{name}: {n_init} launches at init, {n_step} in the step; expected "
              f"{2 * per_fwd} and {6 * per_fwd}")
        check(all(np.isfinite(list(step_terms.values()))), f"{name}: loss terms {step_terms}")
        out["configs"][name] = {"init": n_init, "step": n_step, "peak_gib": peak / 2**30,
                                "first_step_ms": ms}
        print(f"[vqpt-configs] {name} ({c.model.name}, {c.model.params.encoder_name}, {hw}x{hw}, "
              f"batch {TRAIN_BATCH}+{TRAIN_BATCH}): init {n_init} + step {n_step} vq_assign "
              f"launches, first step {ms:.1f} ms, peak memory {peak / 2**30:.2f} GiB; "
              + ", ".join(f"{k} {v:.5f}" for k, v in step_terms.items()) + f" | {card}")
        del st
        torch.cuda.empty_cache()

    # the drivers on phase 7's tree: vqpt for one epoch, then a pretrained
    # vqpt epoch from the VQ-VAE files of its model 1, then easyhard for 1
    test_imgs = DRIVER_TEST
    cfg = load_config(os.path.join(ROOT, "config", f"{VQPT_CONFIG}.json"))
    per_fwd = per_forward(cfg)
    steps = DRIVER_UNLABELLED // cfg.train.batch_size

    def drive(train_fn, c, tag, epochs, **train):
        c = copy.deepcopy(c)
        c.train.update(data_dir=root, save_dir=os.path.join(root, f"runs_{tag}"),
                       num_epochs=epochs, test_every=1, **train)
        c.test.update(data_dir=root, save_dir=os.path.join(root, f"test_{tag}"))
        history = []
        vq_cuda.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state = train_fn(c, history=history)
        seconds = time.perf_counter() - t0
        scratch = sum("FROM SCRATCH" in str(w.message) for w in caught)
        check([h["epoch"] for h in history] == list(range(epochs)), f"{tag} epochs {history}")
        ck_dir = os.path.join(root, f"runs_{tag}", f"{c.project_name}_{c.mode}_0", "ckpoints")
        names = sorted(n for n in os.listdir(ck_dir) if n.endswith(".ckpt"))
        check(names == ["0ep.ckpt", "last.ckpt"], f"{tag} checkpoints {names}")
        for n_ck in names:
            keys = set(ckpoints.load_full(os.path.join(ck_dir, n_ck)))
            check(keys == contract, f"{tag} {n_ck} keys {sorted(keys)}")
        print(f"[{tag}-driver] {train_fn.__name__}: {epochs} epochs x {steps} steps, f32, batch "
              f"{c.train.batch_size}+{c.train.batch_size}, {vq_cuda.launches} vq_assign "
              f"launches; epochs {[round(h['seconds'], 2) for h in history]} s, loss "
              f"{[round(h['loss'], 4) for h in history]}, test miou "
              f"{[h['test_miou'] and round(h['test_miou'], 4) for h in history]}; "
              f"{seconds:.1f} s in all | {card}")
        return state, history, vq_cuda.launches, scratch, ck_dir

    # init (2 forwards), 6 forwards per step, 1 per test image and epoch
    epochs = VARIANT_DRIVER_EPOCHS
    state, history, launches, scratch, ck_dir = drive(train_vqpt_cps, cfg, "vqpt", epochs)
    expect = per_fwd * (2 + 6 * steps * epochs + test_imgs * epochs)
    check(launches == expect, f"train_vqpt_cps launched the kernel {launches} times, not {expect}")
    check(scratch == 1, "expected one from-scratch warning from the vqpt driver")
    check(all(np.isfinite(h[k]) for h in history for k in LOSS_TERMS)
          and all(0.0 <= h["test_miou"] <= 1.0 for h in history), f"vqpt epochs {history}")
    out["vqpt_driver"] = launches

    # the pretrained, frozen-encoder flow from model 1's encoder and codebooks
    vqvae_dir = os.path.join(root, "vqvae")
    os.makedirs(vqvae_dir)
    ckpoints.save_vqvae(state.model_1, epochs - 1, vqvae_dir)
    files = {part: os.path.join(vqvae_dir, f"{epochs - 1}ep_{part}.ckpt")
             for part in ("encoder", "codebook")}
    del state
    torch.cuda.empty_cache()
    state, history, launches, scratch, _ = drive(train_vqpt_cps, cfg, "vqpt_pretrained", 1,
                                                 pretrained=files)
    # the init forwards quantize with the loaded codebooks (no k-means)
    expect = per_fwd * (2 + 6 * steps + test_imgs)
    check(launches == expect, f"pretrained vqpt launched the kernel {launches} times, not {expect}")
    check(scratch == 0, "the pretrained run resolved encoder_weights")
    enc_file = ckpoints.load_full(files["encoder"])
    for label, m in (("model 1", state.model_1), ("model 2", state.model_2)):
        sd = {k: v.cpu() for k, v in m.core.encoder.state_dict().items()}
        params = [k for k, _ in m.core.encoder.named_parameters()]
        changed = [k for k in params if not torch.equal(sd[k], enc_file[k])]
        moved = [k for k in sd if "running" in k and not torch.equal(sd[k], enc_file[k])]
        check(not changed, f"pretrained {label}: encoder parameters changed {changed[:3]}")
        check(moved, f"pretrained {label}: encoder running statistics did not move")
    print(f"[vqpt_pretrained-driver] save_vqvae -> load_vqvae_pretrained: {len(params)} encoder "
          f"parameters bitwise as loaded after the epoch in both models, {len(moved)} running "
          f"statistics moved; {launches} vq_assign launches | {card}")
    out["vqpt_pretrained_driver"] = launches
    del state, enc_file
    torch.cuda.empty_cache()

    ecfg = load_config(os.path.join(ROOT, "config", f"{EASYHARD_CONFIG}.json"))
    state, history, launches, scratch, _ = drive(train_easyhard_cps, ecfg, "easyhard", 1)
    expect = per_forward(ecfg) * (2 + 6 * steps)  # no evaluation
    check(launches == expect,
          f"train_easyhard_cps launched the kernel {launches} times, not {expect}")
    check(scratch == 1, "expected one from-scratch warning from the easyhard driver")
    check(all(h["test_miou"] is None for h in history), "the easyhard driver evaluated")
    check(all(np.isfinite(h[k]) for h in history for k in EASYHARD_TERMS), f"easyhard {history}")
    out["easyhard_driver"] = launches
    del state
    torch.cuda.empty_cache()

    # the test CLI's sweep of the vqpt run, and serving from its last.ckpt
    sweep_cfg = copy.deepcopy(cfg)
    sweep_cfg.test.update(data_dir=root, weights=ck_dir, save_dir=os.path.join(root, "test_vqpt"))
    vq_cuda.launches = 0
    t0 = time.perf_counter()
    best_path, best = test_cli.test(sweep_cfg)
    sweep_s = time.perf_counter() - t0
    out["vqpt_sweep"] = vq_cuda.launches
    check(out["vqpt_sweep"] == per_fwd * test_imgs * 2,
          f"sweep launched the kernel {out['vqpt_sweep']} times")
    check(0.0 <= best["test_miou"] <= 1.0, f"sweep best {best_path} {best}")
    pred = Predictor.from_checkpoint(cfg, os.path.join(ck_dir, "last.ckpt"),
                                     batch_size=cfg.train.batch_size)
    imgs = np.random.default_rng(SEED + 9).integers(
        0, 256, (cfg.train.batch_size, cfg.resize, cfg.resize, 3), dtype=np.uint8)
    vq_cuda.launches = 0
    labels = pred(imgs)
    out["vqpt_serve"] = vq_cuda.launches
    check(out["vqpt_serve"] == per_fwd, f"served batch launched {out['vqpt_serve']}")
    check(labels.shape == imgs.shape[:3] and int(labels.max()) < int(cfg.num_classes),
          f"served labels {labels.shape}, max {int(labels.max())}")
    print(f"[vqpt-driver] test CLI sweep of 2 checkpoints x {test_imgs} images: best "
          f"{os.path.basename(best_path)} test miou {best['test_miou']:.4f}, {out['vqpt_sweep']} "
          f"vq_assign launches, {sweep_s:.1f} s; Predictor.from_checkpoint(last.ckpt): batch "
          f"{cfg.train.batch_size}, labels {sorted(int(v) for v in np.unique(labels))}, "
          f"{out['vqpt_serve']} launches | {card}")
    del pred
    torch.cuda.empty_cache()
    return out


def slice_phase(card: str, vq_cuda, vq_assign_reference, vector_quantizer, root: str) -> dict:
    """Phase 12: ``angularv3``, ``supconcps``, the ``reptcps`` step of
    ``vqreptunetangular``, ``semiweed`` and ``selfsup`` at full width, f32
    as the JAX drivers run them.  Returns the launches of each path and the
    timings."""
    import warnings

    from vq_seg_tpu_torch import load_config
    from vq_seg_tpu_torch import test as test_cli
    from vq_seg_tpu_torch.device import full_f32
    from vq_seg_tpu_torch.serving import Predictor
    from vq_seg_tpu_torch.losses import make_loss
    from vq_seg_tpu_torch.training import (cps_init_phase, create_cps_state, make_lr_schedule,
                                           make_rept_cps_train_step, make_selfsup_train_step,
                                           make_semiweed_train_step, semiweed_draws,
                                           train_angularv3_cps, train_rept_cps, train_selfsup,
                                           train_semiweed, train_supcon_cps, train_vqpt_cps,
                                           vqpt_init_phase, vqpt_step)
    from vq_seg_tpu_torch.training.cps import model_cfg_with_bn
    from vq_seg_tpu_torch.training.supervised import create_state, init_phase
    from vq_seg_tpu_torch.utils import ckpoints

    contract = {"model_1", "model_2", "epoch", "batch_idx", "optimizer_1", "optimizer_2"}
    batches_for = batch_cache(SEED + 12)
    out = {}

    def cfg_of(name):
        return load_config(os.path.join(ROOT, "config", f"{name}.json"))

    def per_forward(c) -> int:
        return sum(1 for k in c.model.params.vq_cfg.num_embeddings if k)

    def tf32_hook(model, seen):
        return model.register_forward_pre_hook(lambda *_: seen.append(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))

    # -- the dual-model steps: angularv3, supconcps, the reptcps step of
    # vqreptunetangular (the last for one step) ---------------------------------------------
    def dual(name):
        """The config, its driver's step and init phase, the step's extra
        arguments and its loss terms."""
        c = cfg_of(name)
        if c.mode == "angularv3":
            init = lambda st, l, t: vqpt_init_phase(st, l, t, extra=("labeled", 0.0))
            return c, vqpt_step(c, c.mode), init, {"th": 0.5}, ANGULAR_TERMS
        if c.mode == "supconcps":
            init = lambda st, l, t: vqpt_init_phase(st, l, t, extra=("label",),
                                                    init_protos=False)
            return c, vqpt_step(c, c.mode), init, {}, SUPCON_TERMS
        tc = c.train
        step = make_rept_cps_train_step(
            make_loss(tc.criterion.name, c.num_classes, ignore_index=255,
                      weight=tc.criterion.get("weight")),
            num_classes=c.num_classes, cps_loss_weight=tc.get("cps_loss_weight", 1.0),
            commitment_loss_weight=tc.get("total_commitment_loss_weight", 1.0),
            prototype_loss_weight=tc.get("total_prototype_loss_weight", 0.01))
        init = lambda st, l, t: cps_init_phase(st, l, t, 100.0)
        return c, step, init, {"drop_percent": REPT_DROP}, LOSS_TERMS

    for name, warmup, timed, profiled in (
            (ANGULAR_CONFIG, SLICE_WARMUP, SLICE_TIMED, SLICE_PROFILED),
            (SUPCON_CONFIG, SLICE_WARMUP, SLICE_TIMED, SLICE_PROFILED),
            (ANGULAR_REPT_CONFIG, 0, 1, 0)):
        c, raw_step, init, extra, terms = dual(name)
        mode, hw = c.mode, int(c.resize)
        check(c.train.batch_size == TRAIN_BATCH, f"{name}: batch size {c.train.batch_size}")
        per_step = 6 * per_forward(c)
        n_steps = warmup + timed + profiled
        batches = batches_for(hw, n_steps + 2)
        step = lambda st, l, t, u: raw_step(st, l, t, u, **extra)
        print(f"[{mode}] {name}: {c.model.name} ({c.model.params.encoder_name}, num_embeddings "
              f"{list(c.model.params.vq_cfg.num_embeddings)}), {hw}x{hw}, batch "
              f"{TRAIN_BATCH}+{TRAIN_BATCH}, f32, {extra or 'no extra argument'}; random weights "
              f"from seed {SEED}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = create_cps_state(model_cfg_with_bn(c), make_lr_schedule(c.train, n_steps),
                                 seed=SEED, encoder_weights=None)
        l_img, target, _ = batches[0]
        vq_cuda.launches = 0
        with full_f32():  # as the drivers run it
            init(state, to_input(l_img), target)
        init_launches = vq_cuda.launches
        check(init_launches == 2 * per_forward(c), f"{mode} init launched {init_launches}")
        post_init = copy.deepcopy(state)
        seen = []
        hook = tf32_hook(state.model_1, seen)
        run_step = step_runner(step, state, batches)
        vq_cuda.launches = 0
        times, launches_per_step, losses, peak = timed_steps(run_step, warmup, timed, vq_cuda)
        launches = vq_cuda.launches
        hook.remove()
        check(seen == [(False, False)] * 3 * (warmup + timed),
              f"TF32 flags seen by the {mode} forwards: {sorted(set(seen))}")
        check(all(n == per_step for n in launches_per_step),
              f"{mode} launches per step {launches_per_step}, expected {per_step}")
        step_terms = {k: float(run_step.metrics[k]) for k in terms}
        check(all(np.isfinite(losses)) and all(np.isfinite(list(step_terms.values()))),
              f"non-finite {mode} losses {losses} {step_terms}")
        p50 = statistics.median(times)
        print(f"[{mode}] init {init_launches} vq_assign launches; {len(launches_per_step)} steps "
              f"({warmup} warm-up), {launches} launches ({per_step} per step); TF32 off in all "
              f"{len(seen)} forwards of model 1 under PyTorch's default flags")
        print(f"[{mode}] f32 step, batch {TRAIN_BATCH}+{TRAIN_BATCH}, {hw}x{hw}: p50 {p50:.3f} "
              f"ms/step ({2 * TRAIN_BATCH * 1e3 / p50:.1f} img/s) over {timed} steps (min "
              f"{min(times):.3f}, max {max(times):.3f}); peak memory {peak / 2**30:.2f} GiB from "
              f"the init on (torch.cuda.max_memory_allocated) | {card}")
        print(f"[{mode}] last step: " + ", ".join(f"{k} {v:.6g}" for k, v in step_terms.items()))
        prof = None
        if profiled:
            prof = profile_window(lambda i: run_step(warmup + timed + i), profiled, "step",
                                  f"{mode}-profile", f"f32 {mode} step", card)
        del state
        l_img, target, ul_img = batches[-1]
        run = lambda st: raw_step(st, to_input(l_img), target, to_input(ul_img), **extra)[1]
        loss_err, grad_err, worst, substituted = kernel_vs_plain_step(
            run, post_init, vq_cuda, vq_assign_reference, vector_quantizer, terms)
        print(f"[{mode}-e2e] f32 step from the post-init state, VQ on the kernel vs on the plain "
              f"version: loss terms max relative difference {loss_err:.3e} (limit "
              f"{SLICE_LOSS_TOL}), gradients max relative L2 {grad_err:.3e} at {worst} (limit "
              f"{SLICE_GRAD_TOL}); near-tie rows given the kernel's code per VQ call: "
              f"{substituted}")
        check(len(substituted) == per_step, f"plain {mode} step made {len(substituted)} VQ calls")
        check(loss_err <= SLICE_LOSS_TOL, f"f32 {mode} loss terms differ by {loss_err}")
        check(grad_err <= SLICE_GRAD_TOL, f"f32 {mode} gradient of {worst} differs by {grad_err}")
        del post_init
        torch.cuda.empty_cache()
        out[name] = {"init_launches": init_launches, "launches": launches,
                     "per_step": launches_per_step, "p50": p50, "peak_gib": peak / 2**30,
                     "vq_ms": prof["vq_ms"] if prof else None,
                     "device_ms": prof["device_ms"] if prof else None,
                     "loss_err": loss_err, "grad_err": grad_err}

    # -- semiweed and selfsup: one model -------------------------------------------------------
    for name, terms in ((SEMIWEED_CONFIG, SEMIWEED_TERMS), (SELFSUP_CONFIG, SELFSUP_TERMS)):
        c = cfg_of(name)
        hw = int(c.resize)
        n_steps = SLICE_WARMUP + SLICE_TIMED + SLICE_PROFILED
        batches = batches_for(hw, n_steps + 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = create_state(c.model, make_lr_schedule(c.train, n_steps), seed=SEED)
        vq_cuda.launches = 0
        if c.mode == "semiweed":
            tc = c.train
            raw = make_semiweed_train_step(
                make_loss(tc.criterion.name, c.num_classes, ignore_index=255),
                num_classes=c.num_classes, overlap_size=tc.get("overlap_size", 240),
                ce_loss_weight=tc.get("ce_loss_weight", 1.0),
                dc_loss_weight=tc.get("dc_loss_weight", 1.0))
            draw = semiweed_draws(c, "cuda")
            step = lambda st, l, t, u: raw(st, l, t, u, *draw())
            per_step, forwards = 0, 3
        else:
            raw = make_selfsup_train_step()

            def step(st, l, t, u):
                st, metrics, _ = raw(st, l)
                return st, metrics

            with full_f32():
                init_phase(state, (to_input(batches[0][0]),))
            per_step, forwards = per_forward(c), 1
        init_launches = vq_cuda.launches
        seen = []
        hook = tf32_hook(state.model, seen)
        run_step = step_runner(step, state, batches)
        vq_cuda.launches = 0
        times, launches_per_step, losses, peak = timed_steps(run_step, SLICE_WARMUP, SLICE_TIMED,
                                                             vq_cuda)
        hook.remove()
        check(seen == [(False, False)] * forwards * (SLICE_WARMUP + SLICE_TIMED),
              f"TF32 flags seen by the {c.mode} forwards: {sorted(set(seen))}")
        check(all(n == per_step for n in launches_per_step),
              f"{c.mode} launches per step {launches_per_step}, expected {per_step}")
        step_terms = {k: float(run_step.metrics[k]) for k in terms}
        check(all(np.isfinite(losses)) and all(np.isfinite(list(step_terms.values()))),
              f"non-finite {c.mode} losses {losses} {step_terms}")
        p50 = statistics.median(times)
        print(f"[{c.mode}] {name}: {c.model.name} ({c.model.params.encoder_name}), {hw}x{hw}, "
              f"batch {TRAIN_BATCH}, f32: init {init_launches} + {sum(launches_per_step)} "
              f"vq_assign launches ({per_step} per step); p50 {p50:.3f} ms/step over "
              f"{SLICE_TIMED} steps (min {min(times):.3f}, max {max(times):.3f}); peak memory "
              f"{peak / 2**30:.2f} GiB; TF32 off in all {len(seen)} forwards | {card}")
        print(f"[{c.mode}] last step: " + ", ".join(f"{k} {v:.6g}" for k, v in step_terms.items()))
        prof = profile_window(lambda i: run_step(SLICE_WARMUP + SLICE_TIMED + i), SLICE_PROFILED,
                              "step", f"{c.mode}-profile", f"f32 {c.mode} step", card)
        del state
        torch.cuda.empty_cache()
        out[name] = {"init_launches": init_launches, "launches": sum(launches_per_step),
                     "per_step": launches_per_step, "p50": p50, "peak_gib": peak / 2**30,
                     "vq_ms": prof["vq_ms"] if prof else None,
                     "device_ms": prof["device_ms"] if prof else None}

    # -- the drivers on phase 7's tree ---------------------------------------------------------
    test_imgs = DRIVER_TEST
    steps = DRIVER_UNLABELLED // TRAIN_BATCH

    def drive(train_fn, c, tag, **train):
        c = copy.deepcopy(c)
        c.train.update({"data_dir": root, "save_dir": os.path.join(root, f"runs_{tag}"),
                        "num_epochs": 1, "test_every": 1, **train})
        c.test.update(data_dir=root, save_dir=os.path.join(root, f"test_{tag}"))
        history = []
        vq_cuda.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            state = train_fn(c, history=history)
        seconds = time.perf_counter() - t0
        check([h["epoch"] for h in history] == [0], f"{tag} epochs {history}")
        print(f"[{tag}-driver] {train_fn.__name__}: 1 epoch, f32, {vq_cuda.launches} vq_assign "
              f"launches; {seconds:.1f} s; " + ", ".join(
                  f"{k} {v:.4g}" for k, v in history[0].items()
                  if isinstance(v, float) and k != "seconds") + f" | {card}")
        return c, state, history, vq_cuda.launches

    for name, fn, tag in ((ANGULAR_CONFIG, train_angularv3_cps, "angularv3"),
                          (SUPCON_CONFIG, train_supcon_cps, "supconcps"),
                          (ANGULAR_REPT_CONFIG, train_rept_cps, "reptcps_angular")):
        c = cfg_of(name)
        c_run, state, history, launches = drive(fn, c, tag)
        expect = per_forward(c) * (2 + 6 * steps + test_imgs)
        check(launches == expect, f"{fn.__name__} launched the kernel {launches}, not {expect}")
        check(np.isfinite(history[0]["loss"]) and 0.0 <= history[0]["test_miou"] <= 1.0,
              f"{tag} epoch {history}")
        ck_dir = os.path.join(c_run.train.save_dir, f"{c.project_name}_{c.mode}_0", "ckpoints")
        names = sorted(os.listdir(ck_dir))
        check(names == ["0ep.ckpt", "last.ckpt"], f"{tag} checkpoints {names}")
        check(set(ckpoints.load_full(os.path.join(ck_dir, "last.ckpt"))) == contract,
              f"{tag} last.ckpt keys")
        out[f"{tag}_driver"] = launches
        if tag == "angularv3":
            sweep_dir, sweep_cfg = ck_dir, c_run
        del state
        torch.cuda.empty_cache()

    c = cfg_of(SEMIWEED_CONFIG)
    c_run, state, history, launches = drive(train_semiweed, c, "semiweed")
    check(launches == 0, f"train_semiweed launched the kernel {launches} times")
    ck = os.path.join(c_run.train.save_dir, f"{c.project_name}_semiweed_0", "ckpoints",
                      "last.ckpt")
    check(set(ckpoints.load_full(ck)) == {"model_1", "epoch", "optimizer_1"},
          "semiweed last.ckpt keys")
    check(np.isfinite(history[0]["loss"]) and 0.0 <= history[0]["test_miou"] <= 1.0,
          f"semiweed epoch {history}")
    out["semiweed_driver"] = launches
    del state

    c = cfg_of(SELFSUP_CONFIG)
    images = os.path.join(root, "train", "input")
    n_images = len(os.listdir(images))
    c_run, state, history, launches = drive(train_selfsup, c, "selfsup", data_dir=images)
    selfsup_steps = -(-n_images // c.train.batch_size)
    expect = per_forward(c) * (1 + selfsup_steps)  # the init phase, then one per step
    check(launches == expect, f"train_selfsup launched the kernel {launches}, not {expect}")
    vqvae_dir = os.path.join(c_run.train.save_dir, "selfsup_ckpoints")
    files = sorted(os.listdir(vqvae_dir))
    check(files == ["0ep_codebook.ckpt", "0ep_decoder.ckpt", "0ep_encoder.ckpt"],
          f"selfsup files {files}")
    out["selfsup_driver"] = launches
    del state
    torch.cuda.empty_cache()

    # the users' flow: a vqpt epoch pretrained from the files selfsup wrote
    pretrained = {p: os.path.join(vqvae_dir, f"0ep_{p}.ckpt") for p in ("encoder", "codebook")}
    c = cfg_of(VQPT_CONFIG)
    _, state, history, launches = drive(train_vqpt_cps, c, "vqpt_from_selfsup",
                                        pretrained=pretrained)
    expect = per_forward(c) * (2 + 6 * steps + test_imgs)
    check(launches == expect, f"pretrained vqpt launched the kernel {launches}, not {expect}")
    enc_file = ckpoints.load_full(pretrained["encoder"])
    cb_file = ckpoints.load_full(pretrained["codebook"])
    for label, m in (("model 1", state.model_1), ("model 2", state.model_2)):
        sd = {k: v.cpu() for k, v in m.core.encoder.state_dict().items()}
        params = [k for k, _ in m.core.encoder.named_parameters()]
        changed = [k for k in params if not torch.equal(sd[k], enc_file[k])]
        check(not changed, f"pretrained {label}: encoder parameters changed {changed[:3]}")
        cbs = {k: v.cpu() for k, v in m.core.codebooks.state_dict().items()}
        check(sorted(cbs) == sorted(cb_file) and all(torch.equal(cbs[k], cb_file[k])
                                                     for k in cbs),
              f"pretrained {label}: codebooks are not the selfsup run's")
    print(f"[vqpt_from_selfsup-driver] the selfsup run's encoder ({len(params)} parameters) "
          f"bitwise as loaded after the epoch in both models, its {len(cb_file)} codebooks "
          f"kept | {card}")
    out["vqpt_from_selfsup_driver"] = launches
    del state, enc_file
    torch.cuda.empty_cache()

    # the test CLI and serving from the angularv3 run's last.ckpt
    c = copy.deepcopy(sweep_cfg)
    c.test.update(data_dir=root, weights=os.path.join(sweep_dir, "last.ckpt"),
                  save_dir=os.path.join(root, "test_sweep12"))
    vq_cuda.launches = 0
    best_path, best = test_cli.test(c)
    out["angularv3_sweep"] = vq_cuda.launches
    per_fwd = per_forward(c)
    check(out["angularv3_sweep"] == per_fwd * test_imgs,
          f"sweep launched the kernel {out['angularv3_sweep']} times")
    check(0.0 <= best["test_miou"] <= 1.0, f"sweep best {best_path} {best}")
    pred = Predictor.from_checkpoint(c, os.path.join(sweep_dir, "last.ckpt"),
                                     batch_size=c.train.batch_size)
    imgs = np.random.default_rng(SEED + 12).integers(
        0, 256, (c.train.batch_size, c.resize, c.resize, 3), dtype=np.uint8)
    vq_cuda.launches = 0
    labels = pred(imgs)
    out["angularv3_serve"] = vq_cuda.launches
    check(out["angularv3_serve"] == per_fwd, f"served batch launched {out['angularv3_serve']}")
    check(labels.shape == imgs.shape[:3] and int(labels.max()) < int(c.num_classes),
          f"served labels {labels.shape}")
    print(f"[angularv3-driver] test CLI on last.ckpt x {test_imgs} images: "
          f"{os.path.basename(best_path)} test miou {best['test_miou']:.4f}, "
          f"{out['angularv3_sweep']} launches; Predictor.from_checkpoint(last.ckpt): "
          f"{out['angularv3_serve']} launches | {card}")
    del pred
    torch.cuda.empty_cache()
    return out


def write_rest_tree(root: str, wh: int, n_lab: int, n_unlab: int, n_test: int, rng) -> None:
    """A PNG tree for phase 13 at ``wh`` x ``wh``: stripes of the three
    classes moved by a class in 32-pixel cells, coloured per class with
    +-4 of noise (smooth enough for SLIC's connectivity pass to stay
    cheap), ``n_lab`` labelled and ``n_unlab`` unlabelled train images and
    ``n_test`` labelled test images."""
    from vq_seg_tpu_torch.utils.visualize import write_png

    stripes = (np.arange(wh) * 6 // wh)[None, :]
    colours = np.array([[40, 40, 40], [60, 160, 60], [160, 60, 60]], np.int16)
    for split, lab, unlab in (("train", n_lab, n_unlab), ("test", n_test, 0)):
        for sub in ("input", "target"):
            os.makedirs(os.path.join(root, split, sub))
        for i in range(lab + unlab):
            cells = rng.integers(0, 2, (wh // 32 + 1, wh // 32 + 1))
            shift = np.kron(cells, np.ones((32, 32), int))
            label = (stripes + shift[:wh, :wh]) % 3
            img = np.clip(colours[label] + rng.integers(-4, 5, (wh, wh, 3)), 0, 255)
            write_png(os.path.join(root, split, "input", f"im{i:03d}.png"), img.astype(np.uint8),
                      level=1)
            if i < lab:
                write_png(os.path.join(root, split, "target", f"im{i:03d}.png"),
                          np.array([0, 128, 255], np.uint8)[label], level=1)


def saliency_job(src: str, dst: str) -> float:
    """The port's ``get_saliency_rbd`` map of the PNG ``src`` written as a
    gray PNG ``dst`` at the image's size; returns the seconds it took (run
    in a worker process)."""
    from PIL import Image

    from vq_seg_tpu_torch.tools.saliency import get_saliency_rbd
    from vq_seg_tpu_torch.utils.visualize import write_png

    t0 = time.perf_counter()
    img = np.asarray(Image.open(src).convert("RGB")) / 255.0
    write_png(dst, np.round(get_saliency_rbd(img) * 255).astype(np.uint8), level=1)
    return time.perf_counter() - t0


def obia_job(train_dir: str) -> float:
    """The port's ``build_pseudo_labels`` over ``train_dir`` into its
    ``obia/``; returns the seconds it took (run in a worker process)."""
    from vq_seg_tpu_torch.tools.obia import build_pseudo_labels

    t0 = time.perf_counter()
    build_pseudo_labels(train_dir, os.path.join(train_dir, "obia"),
                        {"0": 0, "128": 1, "255": 2})
    return time.perf_counter() - t0


def rest_phase(card: str, vq_cuda, vq_assign_reference, vector_quantizer, root: str) -> dict:
    """Phase 13: ``config/obia_CWFID.json`` (fcn32s on vgg19, 512^2, batch
    8, bf16), ``--mode unimatch`` and ``--mode salientcps`` at full width,
    and one step of ``vqunet_v1``, ``unetoriginal``, ``nopt`` and
    ``scheme6``.  Returns the launches of each path, the timings and the
    kernel's cases at the new shapes."""
    import multiprocessing
    import warnings
    from concurrent.futures import ProcessPoolExecutor

    from vq_seg_tpu_torch import load_config
    from vq_seg_tpu_torch import test as test_cli
    from vq_seg_tpu_torch.device import resolve_device
    from vq_seg_tpu_torch.losses import make_loss
    from vq_seg_tpu_torch.serving import Predictor
    from vq_seg_tpu_torch.training import (cps_init_phase, create_cps_state, make_cps_train_step,
                                           make_lr_schedule, make_unimatch_train_step,
                                           plain_init_phase, salient_step, supervised,
                                           train_salient_cps, train_unimatch, unimatch_draws)
    from vq_seg_tpu_torch.training.cps import model_cfg_with_bn
    from vq_seg_tpu_torch.training.variant_drivers import unimatch_state
    from vq_seg_tpu_torch.utils import ckpoints

    out = {"cases": []}
    contract = {"model_1", "model_2", "epoch", "batch_idx", "optimizer_1", "optimizer_2"}
    dev = resolve_device("cuda")

    def cfg_of(name):
        return load_config(os.path.join(ROOT, "config", f"{name}.json"))

    def kernel_cases(tag, forward, expect):
        captured = capture_vq_shapes(vector_quantizer, forward)
        check(len(captured) == expect, f"{tag}: captured {len(captured)} VQ calls, not {expect}")
        for i, (x, cb, metric) in enumerate(captured):
            r = compare_vq(f"{tag}-{i}", x, cb, metric, vq_cuda, vq_assign_reference)
            out["cases"].append(r)
            print(f"[zoo-rest-kernel] vq_assign {r['case']} N={r['n']} C={r['c']} K={r['k']}: "
                  f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}); near-tie rows {r['near_ties']} "
                  f"(max f64 score gap {r['max_abs_err']:.3e}) | {card}")

    # -- the host work: the OBIA pseudo-labels and the saliency maps, in
    # worker processes beside each other ----------------------------------------------------
    obia_root, sal_root = os.path.join(root, "obia_tree"), os.path.join(root, "salient_tree")
    rng = np.random.default_rng(SEED + 13)
    write_rest_tree(obia_root, OBIA_WH, REST_LABELLED, REST_UNLABELLED, DRIVER_TEST, rng)
    write_rest_tree(sal_root, SALIENT_WH, REST_LABELLED, REST_UNLABELLED, 0, rng)
    sal_dir = os.path.join(root, "salient_maps")
    os.makedirs(sal_dir)
    names = sorted(os.listdir(os.path.join(sal_root, "train", "input")))
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1), mp_context=ctx) as pool:
        obia_future = pool.submit(obia_job, os.path.join(obia_root, "train"))
        sal_s = list(pool.map(saliency_job,
                              [os.path.join(sal_root, "train", "input", n) for n in names],
                              [os.path.join(sal_dir, n) for n in names]))
        obia_s = obia_future.result()
    host_s = time.perf_counter() - t0
    n_obia = len(os.listdir(os.path.join(obia_root, "train", "obia")))
    check(n_obia == REST_UNLABELLED, f"OBIA wrote {n_obia} pseudo-masks")
    print(f"[obia] build_pseudo_labels ({REST_LABELLED} labelled, {REST_UNLABELLED} pseudo-"
          f"labelled images at {OBIA_WH}x{OBIA_WH}: SLIC, features, a 100-tree forest) "
          f"{obia_s:.2f} s; get_saliency_rbd of {len(names)} images at {SALIENT_WH}x"
          f"{SALIENT_WH} {min(sal_s):.2f}-{max(sal_s):.2f} s each; {host_s:.2f} s of host time "
          f"in {min(8, os.cpu_count() or 1)} worker processes | {card}")
    out["host_s"] = {"obia": obia_s, "saliency_max": max(sal_s), "wall": host_s}

    # -- (a) obia_CWFID.json at full width ---------------------------------------------------
    c = cfg_of(OBIA_CONFIG)
    hw, tc, nc = int(c.resize), c.train, int(c.num_classes)
    half = bool(tc.half)
    n_steps = REST_WARMUP + REST_TIMED + 1
    batches = train_batches(np.random.default_rng(SEED + 13), n_steps, hw, tc.batch_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = supervised.create_state(model_cfg_with_bn(c), make_lr_schedule(tc, n_steps),
                                    seed=SEED)
    step = supervised.make_sup_train_step(
        make_loss(tc.criterion.name, nc, ignore_index=255, weight=tc.criterion.get("weight")),
        num_classes=nc, forward_mode="plain", half=half)
    dropout = supervised.sup_dropout(c, dev)

    def obia_step(i):
        l_img, target, _ = batches[i]
        _, metrics, _ = step(state, to_input(l_img), target, None, dropout)
        obia_step.metrics = metrics
        return float(metrics["loss"])

    vq_cuda.launches = 0
    times, per_step, losses, peak = timed_steps(obia_step, REST_WARMUP, REST_TIMED, vq_cuda)
    check(vq_cuda.launches == 0, f"fcn32s launched the kernel {vq_cuda.launches} times")
    check(all(np.isfinite(losses)), f"fcn32s losses {losses}")
    p50 = statistics.median(times)
    print(f"[obia] {OBIA_CONFIG}: fcn32s ({c.model.params.encoder_name}), {hw}x{hw}, batch "
          f"{tc.batch_size}, {'bf16 autocast' if half else 'f32'}, criterion {tc.criterion.name}: "
          f"p50 {p50:.3f} ms/step ({tc.batch_size * 1e3 / p50:.1f} img/s) over {REST_TIMED} steps "
          f"(min {min(times):.3f}, max {max(times):.3f}); peak memory {peak / 2**30:.2f} GiB; "
          f"0 vq_assign launches; losses {[round(v, 5) for v in losses]} | {card}")
    prof = profile_window(lambda i: obia_step(REST_WARMUP + REST_TIMED + i), 1, "step",
                          "obia-profile", f"bf16 fcn32s step, batch {tc.batch_size}", card)
    out["obia"] = {"p50": p50, "peak_gib": peak / 2**30, "launches": 0,
                   "device_ms": prof["device_ms"] if prof else None}
    del state, batches
    torch.cuda.empty_cache()

    # the sup driver on the OBIA tree, the test CLI's sweep and serving
    c_run = copy.deepcopy(c)
    c_run.train.update(data_dir=obia_root, save_dir=os.path.join(root, "runs_obia"),
                       num_epochs=1)
    c_run.test.update(data_dir=obia_root, save_dir=os.path.join(root, "test_obia"))
    history = []
    vq_cuda.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        supervised.train(c_run, history=history)
    drv_s = time.perf_counter() - t0
    check(any("FROM SCRATCH" in str(w.message) for w in caught),
          "obia driver: the unresolved imagenet weights did not warn")
    [h] = history
    steps = (REST_LABELLED + REST_UNLABELLED) // tc.batch_size
    check(h["step"] == steps and np.isfinite(h["loss"]) and 0.0 <= h["miou"] <= 1.0,
          f"obia epoch {h}")
    ck_dir = os.path.join(c_run.train.save_dir, f"{c.project_name}_sup_0", "ckpoints")
    last = os.path.join(ck_dir, "last.ckpt")
    check(set(ckpoints.load_full(last)) == {"model_1", "epoch"}, "obia last.ckpt keys")
    c_run.test.update(weights=last)
    best_path, best = test_cli.test(c_run)
    check(0.0 <= best["test_miou"] <= 1.0, f"obia sweep {best_path} {best}")
    pred = Predictor.from_checkpoint(c_run, last, batch_size=tc.batch_size)
    imgs = np.random.default_rng(SEED + 13).integers(0, 256, (tc.batch_size, hw, hw, 3),
                                                     dtype=np.uint8)
    labels = pred(imgs)
    check(labels.shape == imgs.shape[:3] and int(labels.max()) < nc, f"obia served {labels.shape}")
    check(vq_cuda.launches == 0, f"the obia driver, sweep and serving launched {vq_cuda.launches}")
    print(f"[obia-driver] train on the OBIA tree ({REST_LABELLED} targets + {n_obia} OBIA "
          f"pseudo-targets): 1 epoch x {steps} steps in {drv_s:.1f} s, loss {h['loss']:.4f}; the "
          f"test CLI on last.ckpt: test miou {best['test_miou']:.4f}; Predictor.from_checkpoint "
          f"served a batch of {tc.batch_size}; 0 vq_assign launches | {card}")
    del pred
    torch.cuda.empty_cache()

    # -- (b) unimatch at semiweednet.json's width ----------------------------------------------
    c = cfg_of(SEMIWEED_CONFIG)
    c.update(mode="unimatch", project_name="unimatch")
    c.model.name = "unimatch"
    hw, tc = int(c.resize), c.train
    n_steps = REST_WARMUP + REST_TIMED
    batches = batch_cache(SEED + 13)(hw, n_steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = unimatch_state(c, make_lr_schedule(tc, n_steps), dev)
    raw = make_unimatch_train_step(num_classes=int(c.num_classes),
                                   confidence_threshold=tc.get("confidence_threshold", 0.95))
    draw = unimatch_draws(c, dev)
    run_step = step_runner(lambda st, l, t, u: raw(st, l, t, u, *draw(u.shape[-2:])), state,
                           batches)
    vq_cuda.launches = 0
    times, per_step, losses, peak = timed_steps(run_step, REST_WARMUP, REST_TIMED, vq_cuda)
    check(vq_cuda.launches == 0, f"unimatch launched the kernel {vq_cuda.launches} times")
    terms = {k: float(run_step.metrics[k]) for k in ("loss", "sup_loss", "loss_u_1", "loss_u_2",
                                                      "loss_u_fp")}
    check(all(np.isfinite(losses)) and all(np.isfinite(list(terms.values()))),
          f"unimatch losses {losses} {terms}")
    p50 = statistics.median(times)
    print(f"[unimatch] {c.model.params.encoder_name}, output stride 16, {hw}x{hw}, batch "
          f"{TRAIN_BATCH}+{TRAIN_BATCH}, f32: p50 {p50:.3f} ms/step over {REST_TIMED} steps (min "
          f"{min(times):.3f}, max {max(times):.3f}); peak memory {peak / 2**30:.2f} GiB; 0 "
          f"vq_assign launches; last step " + ", ".join(f"{k} {v:.5g}" for k, v in terms.items())
          + f" | {card}")
    prof = profile_window(lambda i: run_step(i), 1, "step", "unimatch-profile",
                          "f32 unimatch step", card)
    out["unimatch"] = {"p50": p50, "peak_gib": peak / 2**30, "launches": 0,
                       "device_ms": prof["device_ms"] if prof else None}
    del state
    torch.cuda.empty_cache()
    c_run = copy.deepcopy(c)
    c_run.train.update(data_dir=root, save_dir=os.path.join(root, "runs_unimatch"),
                       num_epochs=1, test_every=1)
    c_run.test.update(data_dir=root, save_dir=os.path.join(root, "test_unimatch"))
    history = []
    vq_cuda.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        train_unimatch(c_run, history=history)
    [h] = history
    check(vq_cuda.launches == 0, f"train_unimatch launched the kernel {vq_cuda.launches} times")
    check(np.isfinite(h["loss"]) and 0.0 <= h["test_miou"] <= 1.0, f"unimatch epoch {h}")
    last = os.path.join(c_run.train.save_dir, "unimatch_unimatch_0", "ckpoints", "last.ckpt")
    check(set(ckpoints.load_full(last)) == {"model_1", "epoch", "optimizer_1"},
          "unimatch last.ckpt keys")
    print(f"[unimatch-driver] train_unimatch: 1 epoch x {h['step']} steps on phase 7's tree in "
          f"{time.perf_counter() - t0:.1f} s, loss {h['loss']:.4f}, test miou "
          f"{h['test_miou']:.4f}; 0 vq_assign launches | {card}")
    out["unimatch_driver"] = 0
    torch.cuda.empty_cache()

    # -- (c) salientcps at the flagship's width ------------------------------------------------
    base = cfg_of("vqreptunet1x1v2")
    c = copy.deepcopy(base)
    c.update(mode="salientcps", project_name="salient")
    p = base.model.params
    c.model = type(c.model)({"name": "VQUnetwithSalientloss",
                             "params": {k: p[k] for k in ("encoder_name", "num_classes",
                                                          "vq_cfg")}})
    c.train.update(salient_dir=sal_dir)
    hw, tc = int(c.resize), c.train
    per_fwd = sum(1 for k in p.vq_cfg.num_embeddings if k)
    n_steps = REST_WARMUP + REST_TIMED + 1
    batches = batch_cache(SEED + 14)(hw, n_steps + 1)
    sal_rng = np.random.default_rng(SEED + 14)
    sal_maps = [tuple(torch.from_numpy(sal_rng.random((b[0].shape[0], hw, hw), np.float32)).cuda()
                      for _ in range(2)) for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = create_cps_state(model_cfg_with_bn(c), make_lr_schedule(tc, n_steps), seed=SEED,
                             encoder_weights=None)
    vq_cuda.launches = 0
    plain_init_phase(state, to_input(batches[0][0]), batches[0][1])
    init_launches = vq_cuda.launches
    check(init_launches == 2 * per_fwd, f"salientcps init launched {init_launches}, not 6")
    post_init = copy.deepcopy(state)
    raw = salient_step(c)

    def salient_run(i):
        l_img, target, ul_img = batches[i]
        l_sal, ul_sal = sal_maps[i]
        _, metrics = raw(state, to_input(l_img), target, l_sal, to_input(ul_img), ul_sal)
        salient_run.metrics = metrics
        return float(metrics["loss"])

    vq_cuda.launches = 0
    times, per_step, losses, peak = timed_steps(salient_run, REST_WARMUP, REST_TIMED, vq_cuda)
    launches = vq_cuda.launches
    check(all(n == 4 * per_fwd for n in per_step),
          f"salientcps launches per step {per_step}, expected {4 * per_fwd}")
    terms = {k: float(salient_run.metrics[k]) for k in SALIENT_TERMS}
    check(all(np.isfinite(losses)) and all(np.isfinite(list(terms.values()))),
          f"salientcps losses {losses} {terms}")
    p50 = statistics.median(times)
    print(f"[salientcps] VQUnetwithSalientloss ({p.encoder_name}, num_embeddings "
          f"{list(p.vq_cfg.num_embeddings)}), {hw}x{hw}, batch {TRAIN_BATCH}+{TRAIN_BATCH}, f32: "
          f"init {init_launches} vq_assign launches, then {launches} over {len(per_step)} steps "
          f"({4 * per_fwd} per step); p50 {p50:.3f} ms/step over {REST_TIMED} steps (min "
          f"{min(times):.3f}, max {max(times):.3f}); peak memory {peak / 2**30:.2f} GiB; last "
          f"step " + ", ".join(f"{k} {v:.5g}" for k, v in terms.items()) + f" | {card}")
    prof = profile_window(lambda i: salient_run(REST_WARMUP + REST_TIMED + i), 1, "step",
                          "salientcps-profile", "f32 salientcps step", card)
    kernel_cases("salientcps", lambda: _no_grad_train_pass(state.model_1,
                                                           to_input(batches[1][0])), per_fwd)
    del state
    l_img, target, ul_img = batches[-1]
    l_sal, ul_sal = sal_maps[-1]
    run = lambda st: raw(st, to_input(l_img), target, l_sal, to_input(ul_img), ul_sal)[1]
    loss_err, grad_err, worst, substituted = kernel_vs_plain_step(
        run, post_init, vq_cuda, vq_assign_reference, vector_quantizer, SALIENT_TERMS)
    print(f"[salientcps-e2e] f32 step from the post-init state, VQ on the kernel vs on the plain "
          f"version: loss terms max relative difference {loss_err:.3e} (limit {SLICE_LOSS_TOL}), "
          f"gradients max relative L2 {grad_err:.3e} at {worst} (limit {SLICE_GRAD_TOL}); "
          f"near-tie rows given the kernel's code per VQ call: {substituted}")
    check(len(substituted) == 4 * per_fwd, f"plain salientcps step made {len(substituted)} calls")
    check(loss_err <= SLICE_LOSS_TOL, f"f32 salientcps loss terms differ by {loss_err}")
    check(grad_err <= SLICE_GRAD_TOL, f"f32 salientcps gradient of {worst} differs by {grad_err}")
    del post_init
    torch.cuda.empty_cache()
    out["salientcps"] = {"init_launches": init_launches, "launches": launches,
                         "per_step": per_step, "p50": p50, "peak_gib": peak / 2**30,
                         "device_ms": prof["device_ms"] if prof else None,
                         "vq_ms": prof["vq_ms"] if prof else None,
                         "loss_err": loss_err, "grad_err": grad_err}
    c_run = copy.deepcopy(c)
    c_run.train.update(data_dir=sal_root, save_dir=os.path.join(root, "runs_salient"),
                       num_epochs=1)
    history = []
    vq_cuda.launches = 0
    t0 = time.perf_counter()
    train_salient_cps(c_run, history=history)
    [h] = history
    steps = -(-REST_UNLABELLED // TRAIN_BATCH)
    expect = per_fwd * (2 + 4 * steps)
    check(vq_cuda.launches == expect,
          f"train_salient_cps launched the kernel {vq_cuda.launches} times, not {expect}")
    check(np.isfinite(h["loss"]) and h["test_miou"] is None, f"salientcps epoch {h}")
    ck_dir = os.path.join(c_run.train.save_dir, "salient_salientcps_0", "ckpoints")
    check(sorted(os.listdir(ck_dir)) == ["0ep.ckpt", "last.ckpt"], "salientcps checkpoints")
    check(set(ckpoints.load_full(os.path.join(ck_dir, "last.ckpt"))) == contract,
          "salientcps last.ckpt keys")
    print(f"[salientcps-driver] train_salient_cps: 1 epoch x {steps} steps on the {SALIENT_WH}"
          f"x{SALIENT_WH} tree with get_saliency_rbd maps in {time.perf_counter() - t0:.1f} s, "
          f"{vq_cuda.launches} vq_assign launches ({2 * per_fwd} init + {4 * per_fwd} per "
          f"step), loss {h['loss']:.4f}, salient_loss {h['salient_loss']:.4f} | {card}")
    out["salientcps_driver"] = vq_cuda.launches
    torch.cuda.empty_cache()

    # -- (d) one step of each of the other new networks ----------------------------------------
    flagship = cfg_of("vqreptunet1x1v2")
    zoo = {}
    for name, size in (("vqunet_v1", int(flagship.resize)),
                       ("unetoriginal", int(cfg_of("CWFID_Unet").resize))):
        c = copy.deepcopy(flagship)
        params = ({"encoder_name": p.encoder_name, "num_classes": int(c.num_classes),
                   "vq_cfg": p.vq_cfg} if name == "vqunet_v1"
                  else {"num_classes": int(c.num_classes)})
        c.model = type(c.model)({"name": name, "params": params})
        expect = 1 if name == "vqunet_v1" else 0
        batches = train_batches(np.random.default_rng(SEED + 15), 2, size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = supervised.create_state(model_cfg_with_bn(c), make_lr_schedule(c.train, 1),
                                        seed=SEED)
        step = supervised.make_sup_train_step(make_loss("dice_loss", int(c.num_classes),
                                                        ignore_index=255),
                                              num_classes=int(c.num_classes),
                                              forward_mode="plain", half=True)
        vq_cuda.launches = 0
        supervised.init_phase(state, (to_input(batches[0][0]),), seed=SEED, half=True)
        init_launches = vq_cuda.launches
        vq_cuda.launches = 0
        t0 = time.perf_counter()
        _, metrics, _ = step(state, to_input(batches[1][0]), batches[1][1], None)
        loss = float(metrics["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        step_launches = vq_cuda.launches
        check(init_launches == expect and step_launches == expect and np.isfinite(loss),
              f"{name}: init {init_launches}, step {step_launches} launches, loss {loss}")
        zoo[name] = {"init": init_launches, "step": step_launches, "ms": ms,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if name == "vqunet_v1":
            kernel_cases("vqunet_v1", lambda: _no_grad_train_pass(state.model,
                                                                  to_input(batches[1][0])), 1)
        print(f"[zoo-rest] {name} ({params.get('encoder_name', 'textbook U-Net')}), {size}x{size}, "
              f"batch {TRAIN_BATCH}, bf16, sup: init {init_launches} + step {step_launches} "
              f"vq_assign launches ({expect} per forward); first step {ms:.1f} ms, loss "
              f"{loss:.5f}; peak memory {zoo[name]['peak_gib']:.2f} GiB | {card}")
        del state, batches
        torch.cuda.empty_cache()
    hw, tc = int(flagship.resize), flagship.train
    th, half = float(tc.confidence_threshold), bool(tc.half)
    batches = train_batches(np.random.default_rng(SEED + 16), 2, hw)
    for name in ("nopt", "scheme6"):
        c = copy.deepcopy(flagship)
        c.model.name = name
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = create_cps_state(c.model, make_lr_schedule(tc, 1), seed=SEED, encoder_weights=None)
        dice = make_loss(tc.criterion.name, int(c.num_classes), ignore_index=255,
                         weight=tc.criterion.get("weight"))
        step = make_cps_train_step(dice, num_classes=int(c.num_classes), confidence_threshold=th,
                                   cps_loss_weight=tc.cps_loss_weight,
                                   commitment_loss_weight=tc.total_commitment_loss_weight,
                                   prototype_loss_weight=tc.total_prototype_loss_weight,
                                   ce_weight=tc.criterion.get("weight"), half=half)
        vq_cuda.launches = 0
        cps_init_phase(state, to_input(batches[0][0]), batches[0][1], th, seed=SEED, half=half)
        init_launches = vq_cuda.launches
        vq_cuda.launches = 0
        t0 = time.perf_counter()
        _, metrics, _, _ = step(state, to_input(batches[1][0]), batches[1][1],
                                to_input(batches[1][2]))
        loss, proto = float(metrics["loss"]), float(metrics["prototype_loss"])
        ms = (time.perf_counter() - t0) * 1e3
        check(init_launches == 6 and vq_cuda.launches == VQ_PER_STEP and np.isfinite(loss),
              f"{name}: init {init_launches}, step {vq_cuda.launches} launches, loss {loss}")
        check((proto == 0.0) == (name == "nopt"), f"{name}: prototype loss {proto}")
        zoo[name] = {"init": init_launches, "step": vq_cuda.launches, "ms": ms,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"[zoo-rest] {name} (the flagship's config, {p.encoder_name}, {hw}x{hw}, batch "
              f"{TRAIN_BATCH}+{TRAIN_BATCH}, {'bf16' if half else 'f32'}, cps): init "
              f"{init_launches} + step {vq_cuda.launches} vq_assign launches; first step "
              f"{ms:.1f} ms, loss {loss:.5f}, prototype_loss {proto:.5g}; peak memory "
              f"{zoo[name]['peak_gib']:.2f} GiB | {card}")
        del state
        torch.cuda.empty_cache()
    out["zoo"] = zoo
    return out


def _no_grad_train_pass(model, x):
    """One train-mode forward of ``model`` on ``x`` without gradients, on a
    copy (the running statistics of ``model`` stay)."""
    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        probe(x, train=True)


def main() -> int:
    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    try:
        import vq_seg_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable here: {e}", file=sys.stderr)
        return 1
    from vq_seg_tpu_torch import load_config
    from vq_seg_tpu_torch.models.modules import vector_quantizer
    from vq_seg_tpu_torch.models.networks import make_model
    from vq_seg_tpu_torch.ops import vq_cuda
    from vq_seg_tpu_torch.ops.vq import vq_assign_reference
    from vq_seg_tpu_torch.serving import Predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the logger must never reach the network: wandb, where installed, is
    # switched off (without it the logger writes JSONL)
    os.environ["WANDB_MODE"] = "disabled"
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    print("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False")

    # -- 2. build ----------------------------------------------------------
    info = vq_cuda.build()
    print(f"[build] {os.path.relpath(vq_cuda.SOURCE, ROOT)} -> "
          f"{os.path.relpath(info['path'], ROOT)}: "
          f"{'built' if info['built'] else 'reused'} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")

    # -- 3. serving path at full width -------------------------------------
    cfg = load_config(CONFIG)
    hw = int(cfg.resize)
    num_classes = int(cfg.model.params.num_classes)
    model = make_model(cfg.model, device="cuda", generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    init_imgs = rng.integers(0, 256, size=(BATCH, hw, hw, 3), dtype=np.uint8)
    x_init = torch.from_numpy(init_imgs).cuda().permute(0, 3, 1, 2).float() / 255.0
    t0 = time.perf_counter()
    model.init_codebook_(x_init, torch.Generator().manual_seed(SEED + 1))
    torch.cuda.synchronize()
    vqs = [vq for vq in model.core.codebooks if hasattr(vq, "embedding")]
    uniq = [int(torch.unique(vq.embedding, dim=0).shape[0]) for vq in vqs]
    print(f"[serve] {cfg.model.params.encoder_name}, num_embeddings "
          f"{list(cfg.model.params.vq_cfg.num_embeddings)}, {hw}x{hw}: k-means init "
          f"({vqs[-1].kmeans_iters} iterations) in {time.perf_counter() - t0:.2f} s; "
          f"unique codebook rows per VQ stage {uniq}")

    pred = Predictor(model, input_hw=(hw, hw), batch_size=BATCH, half=True)
    batches = [rng.integers(0, 256, size=(BATCH, hw, hw, 3), dtype=np.uint8)
               for _ in range(STREAM_BATCHES)]
    partial = rng.integers(0, 256, size=(PARTIAL, hw, hw, 3), dtype=np.uint8)
    pred(batches[0])  # warm-up: cuDNN and allocator set-up
    torch.cuda.synchronize()

    vq_cuda.launches = 0
    streamed = list(pred.predict_stream(batches))
    tail = pred(partial)
    times = []
    for i in range(TIMED_BATCHES):
        t0 = time.perf_counter()
        pred(batches[i % STREAM_BATCHES])
        times.append((time.perf_counter() - t0) * 1e3)
    launches = vq_cuda.launches
    forwards = STREAM_BATCHES + 1 + TIMED_BATCHES

    check(len(streamed) == STREAM_BATCHES, f"predict_stream yielded {len(streamed)} batches")
    for lab in streamed:
        check(lab.shape == (BATCH, hw, hw) and lab.dtype == np.uint8,
              f"labels {lab.shape} {lab.dtype}")
    check(tail.shape == (PARTIAL, hw, hw) and tail.dtype == np.uint8, f"tail {tail.shape}")
    for lab in streamed + [tail]:
        check(int(lab.max()) < num_classes, f"label {int(lab.max())} outside [0, {num_classes})")
    check(launches == 3 * forwards,
          f"vq_assign kernel launched {launches} times in {forwards} forwards, expected 3 each")
    seq = [pred(b) for b in batches]
    agree = float(np.mean([np.mean(a == b) for a, b in zip(streamed, seq)]))
    check(agree >= 0.999, f"predict_stream vs sequential label agreement {agree}")
    seen = sorted(int(v) for v in np.unique(np.concatenate([lab.ravel() for lab in streamed])))
    p50 = statistics.median(times)
    p90 = statistics.quantiles(times, n=10, method="inclusive")[-1]
    print(f"[serve] {forwards} forwards, {launches} vq_assign launches (3 per forward); "
          f"classes seen {seen}; predict_stream vs sequential label agreement {agree}")
    print(f"[serve] bf16, batch {BATCH}, {hw}x{hw}, one call at a time: p50 {p50:.3f} ms/batch "
          f"({BATCH * 1e3 / p50:.1f} img/s), p90 {p90:.3f} ms over {TIMED_BATCHES} batches "
          f"(min {min(times):.3f}, max {max(times):.3f} ms) | {card}")
    t0 = time.perf_counter()
    n_streamed = sum(1 for _ in pred.predict_stream(batches[i % STREAM_BATCHES]
                                                    for i in range(THROUGHPUT_BATCHES)))
    stream_s = time.perf_counter() - t0
    print(f"[serve] bf16, batch {BATCH}, {hw}x{hw}, predict_stream over {n_streamed} batches: "
          f"{n_streamed * BATCH / stream_s:.1f} img/s | {card}")
    profile_window(lambda i: pred(batches[i % len(batches)]), PROFILED_BATCHES, "batch",
                   "profile", f"bf16 batch {BATCH}", card)

    # -- 4. kernel against its plain version --------------------------------
    captured = capture_vq_shapes(vector_quantizer,
                                 lambda: pred.logits(torch.from_numpy(batches[0]).cuda()))
    check(len(captured) == 3, f"captured {len(captured)} VQ calls, expected 3")

    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(f"stage{3 + i}", x, cb, m) for i, (x, cb, m) in enumerate(captured)]
    # k-means can leave exactly duplicated codes; these random-weight
    # codebooks have none, so stage 4 is also run with its upper half a copy
    # of the lower half: every row then meets exact ties across blocks
    x4, cb4, m4 = captured[1]
    half = cb4.shape[0] // 2
    cases.append(("stage4-dup", x4, torch.cat([cb4[:half], cb4[:half]]).contiguous(), m4))
    xr = torch.randn(1000, 128, device="cuda", generator=g)
    cbr = torch.randn(256, 128, device="cuda", generator=g)
    cases.append(("ragged", xr, cbr, "euclidean"))
    # C and K below one float4 and one tile
    cases.append(("narrow", torch.randn(100, 3, device="cuda", generator=g),
                  torch.randn(5, 3, device="cuda", generator=g), "euclidean"))
    cbt = torch.randn(256, 128, device="cuda", generator=g)
    cbt[128] = cbt[7]  # duplicate row: an exact tie that must go to code 7
    cases.append(("tie", cbt[7].repeat(300, 1).contiguous(), cbt, "euclidean"))
    cases.append(("cosine", torch.nn.functional.normalize(xr, dim=-1),
                  torch.nn.functional.normalize(cbr, dim=-1), "cosine"))
    results = []
    for name, x, cb, metric in cases:
        r = compare_vq(name, x, cb, metric, vq_cuda, vq_assign_reference)
        results.append(r)
        print(f"[kernel] vq_assign {name} N={r['n']} C={r['c']} K={r['k']} {metric}: "
              f"kernel {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s of 2NKC), "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: 3xTF32 operations {r['ops_ms']:.4f}, bytes "
              f"{r['bytes_ms']:.4f}; f32 SIMT bound {r['f32_simt_bound_ms']:.4f}); "
              f"near-tie rows {r['near_ties']} (max f64 score gap {r['max_abs_err']:.3e}), "
              f"duplicate codebook rows {r['duplicate_rows']} | {card}")
    tie = next(r for r in results if r["case"] == "tie")
    check(tie["near_ties"] == 0, "tie case: kernel and plain version disagree")

    # -- 5. f32 end to end ------------------------------------------------------
    pred32 = Predictor(model, input_hw=(hw, hw), batch_size=BATCH, half=False)
    img = torch.from_numpy(batches[1]).cuda()
    substituted = []
    logits_kernel = pred32.logits(img)
    dispatch = vector_quantizer.vq_assign
    vector_quantizer.vq_assign = plain_vq_with_kernel_ties(vq_cuda, vq_assign_reference, substituted)
    try:
        logits_plain = pred32.logits(img)
    finally:
        vector_quantizer.vq_assign = dispatch
    check(tuple(logits_kernel.shape) == (BATCH, num_classes, hw, hw),
          f"f32 logits shape {tuple(logits_kernel.shape)}")
    check(bool(torch.isfinite(logits_kernel).all()), "non-finite f32 logits")
    dmax = float((logits_kernel - logits_plain).abs().max())
    print(f"[e2e] f32 logits {tuple(logits_kernel.shape)}, VQ on the kernel vs on the plain "
          f"version: |dlogits|max {dmax:.3e} (limit {E2E_TOL}); near-tie rows given the "
          f"kernel's code in the plain run, per stage: {substituted}")
    check(dmax <= E2E_TOL, f"f32 |dlogits|max {dmax} > {E2E_TOL}")

    # -- 6. training at full width ---------------------------------------------------
    train = train_phase(cfg, card, vq_cuda, vq_assign_reference, vector_quantizer)

    # -- 7-9. the drivers at full width, on one PNG tree ----------------------------------
    root = tempfile.mkdtemp(prefix="vq_seg_driver_")
    try:
        driver = driver_phase(cfg, card, vq_cuda, vq_assign_reference, vector_quantizer,
                              train["p50"], root)
        # phase 8 under PyTorch's default TF32 flags: the reptcps trainer
        # pins f32 itself, and the times are those of its own setting
        torch.backends.cudnn.allow_tf32 = True
        try:
            rept = rept_phase(card, vq_cuda, vq_assign_reference, vector_quantizer, root)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        sup = sup_phase(card, vq_cuda, vq_assign_reference, vector_quantizer, root)
        # -- 10. plaincps and objcps, and 11. vqpt and easyhard, under
        # PyTorch's default TF32 flags as phase 8: the drivers pin f32
        # themselves
        torch.backends.cudnn.allow_tf32 = True
        try:
            plain = plain_phase(card, vq_cuda, vq_assign_reference, vector_quantizer, root)
            t_vqpt = time.perf_counter()
            vqpt = vqpt_phase(card, vq_cuda, vq_assign_reference, vector_quantizer, root)
            print(f"[vqpt] phase 11 in {time.perf_counter() - t_vqpt:.1f} s | {card}")
            # -- 12. angularv3, supconcps, semiweed and selfsup
            t_slice = time.perf_counter()
            slice12 = slice_phase(card, vq_cuda, vq_assign_reference, vector_quantizer, root)
            print(f"[slice] phase 12 in {time.perf_counter() - t_slice:.1f} s | {card}")
            # -- 13. obia_CWFID.json, unimatch, salientcps and the rest of the registry
            t_rest = time.perf_counter()
            rest = rest_phase(card, vq_cuda, vq_assign_reference, vector_quantizer, root)
            print(f"[zoo-rest] phase 13 in {time.perf_counter() - t_rest:.1f} s | {card}")
        finally:
            torch.backends.cudnn.allow_tf32 = False
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # -- 14. result lines -----------------------------------------------------------
    main_path = results[:len(captured)]  # the three shapes the serving forward gave
    shape_keys = ("case", "n", "c", "k", "ms", "plain_ms", "bound_ms", "f32_simt_bound_ms",
                  "near_ties", "max_abs_err")
    kernels = [{
        "name": "vq_assign",
        "route": "cuda",
        "source": "vq_seg_tpu_torch/csrc/vq_assign.cu",
        "replaces": "vq_seg_tpu/ops/vq_pallas.py:89",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results + train["cases"] + driver["cases"]
                           + [c for name, _ in SUP_CONFIGS for c in sup[name]["cases"]]
                           + plain["cases"] + rest["cases"]),
        # per forward: the three main-path shapes summed
        "ms": sum(r["ms"] for r in main_path),
        "plain_ms": sum(r["plain_ms"] for r in main_path),
        "bound_ms": sum(r["bound_ms"] for r in main_path),
        "f32_simt_bound_ms": sum(r["f32_simt_bound_ms"] for r in main_path),
        "bound_by": max(main_path, key=lambda r: r["bound_ms"])["bound_by"],
        # no single PyTorch call computes the fused argmin and the counts
        "library_ms": None,
        "shapes": [{key: r[key] for key in shape_keys} for r in main_path],
        # the training path: launches counted over its warm-up and timed
        # steps; the kernels' device time per step from the profiled steps
        # (None where the trace held no device activity); the bound of the
        # step's 18 calls, six at each of the three training shapes
        "launches_train": train["launches"],
        "launches_per_step": train["per_step"],
        "train_device_ms_per_step": train["vq_ms_per_step"],
        "train_bound_ms_per_step": 6 * sum(r["bound_ms"] for r in train["cases"]),
        "train_shapes": [{key: r[key] for key in shape_keys} for r in train["cases"]],
        # the driver phase: train, resume, sweep and serve, each counted
        # from 0; the evaluation forward's shapes (batch 1)
        "launches_driver": driver["launches"],
        "launches_driver_by_path": driver["launches_by_path"],
        "eval_shapes": [{key: r[key] for key in shape_keys} for r in driver["cases"]],
        # phase 8, reptcps (f32): init, the warm-up and timed steps, one
        # step of each sibling config (init included), and the driver; the
        # profiled steps' device time per step, of the VQ kernels and of
        # the whole step
        "launches_rept_init": rept["init_launches"],
        "launches_rept_steps": rept["launches"],
        "launches_rept_siblings": rept["siblings"],
        "launches_rept_driver": rept["driver_launches"],
        "rept_vq_device_ms_per_step": rept["vq_ms"],
        "rept_step_device_ms_per_step": rept["device_ms"],
        # phase 9, sup (bf16): per config, init and steps; the driver
        "launches_sup": {name: {"init": sup[name]["init_launches"],
                                "steps": sup[name]["launches"]} for name, _ in SUP_CONFIGS},
        "launches_sup_driver": sup["driver_launches"],
        "sup_shapes": [{key: r[key] for key in shape_keys}
                       for name, _ in SUP_CONFIGS for r in sup[name]["cases"]],
        # phase 10, plaincps / objcps (f32): init and the warm-up and
        # timed steps of vqcanet.json and vqcanet_obj_loss.json, one step
        # of each shipped config (init included), the drivers, the sweep
        # and serving; the profiled plaincps steps' device time per step;
        # the kernel at the new shapes (ConvNeXt, vqatunet's 256^2, the
        # K=3 head over C=32 decoder channels)
        "launches_plain_init": plain["plaincps"]["init_launches"],
        "launches_plain_steps": plain["plaincps"]["launches"],
        "launches_plain_per_step": plain["plaincps"]["per_step"],
        "launches_obj_init": plain["objcps"]["init_launches"],
        "launches_obj_steps": plain["objcps"]["launches"],
        "launches_obj_per_step": plain["objcps"]["per_step"],
        "launches_plain_configs": {n: {"init": v["init"], "step": v["step"]}
                                   for n, v in plain["configs"].items()},
        "launches_plain_driver": plain["plaincps_driver"],
        "launches_obj_driver": plain["objcps_driver"],
        "launches_plain_sweep": plain["plaincps_sweep"],
        "launches_plain_serve": plain["plaincps_serve"],
        "plain_vq_device_ms_per_step": plain["plaincps"]["vq_ms"],
        "plain_step_device_ms_per_step": plain["plaincps"]["device_ms"],
        "plain_shapes": [{key: r[key] for key in shape_keys} for r in plain["cases"]],
        # phase 11, vqpt / easyhard (f32): init and the warm-up and timed
        # steps of vq_pt_unet.json and vq_pt_unet_easyhard.json, one step of
        # each other shipped config (init included), the drivers (vqpt for
        # 2 epochs, a pretrained vqpt epoch, easyhard for 1), the sweep and
        # serving; the profiled vqpt steps' device time per step
        "launches_vqpt_init": vqpt["vqpt"]["init_launches"],
        "launches_vqpt_steps": vqpt["vqpt"]["launches"],
        "launches_vqpt_per_step": vqpt["vqpt"]["per_step"],
        "launches_easyhard_init": vqpt["easyhard"]["init_launches"],
        "launches_easyhard_steps": vqpt["easyhard"]["launches"],
        "launches_easyhard_per_step": vqpt["easyhard"]["per_step"],
        "launches_vqpt_configs": {n: {"init": v["init"], "step": v["step"]}
                                  for n, v in vqpt["configs"].items()},
        "launches_vqpt_driver": vqpt["vqpt_driver"],
        "launches_vqpt_pretrained_driver": vqpt["vqpt_pretrained_driver"],
        "launches_easyhard_driver": vqpt["easyhard_driver"],
        "launches_vqpt_sweep": vqpt["vqpt_sweep"],
        "launches_vqpt_serve": vqpt["vqpt_serve"],
        "vqpt_vq_device_ms_per_step": vqpt["vqpt"]["vq_ms"],
        "vqpt_step_device_ms_per_step": vqpt["vqpt"]["device_ms"],
        # phase 12 (f32): init and the warm-up and timed steps of
        # vqreptunetangularv3.json (angularv3), sup_con_loss.json
        # (supconcps), one reptcps step of vqreptunetangular.json,
        # semiweednet.json (no VQ) and vqvaev2_selfsup.json; the drivers
        # (one epoch each), the vqpt epoch pretrained from the selfsup run's
        # files, the sweep and serving; the profiled steps' device time
        "launches_slice": {n: {"init": slice12[n]["init_launches"],
                               "steps": slice12[n]["launches"],
                               "per_step": slice12[n]["per_step"]}
                           for n in (ANGULAR_CONFIG, SUPCON_CONFIG, ANGULAR_REPT_CONFIG,
                                     SEMIWEED_CONFIG, SELFSUP_CONFIG)},
        "launches_slice_drivers": {k: v for k, v in slice12.items() if k.endswith(
            ("_driver", "_sweep", "_serve"))},
        "slice_vq_device_ms_per_step": {n: slice12[n]["vq_ms"] for n in (
            ANGULAR_CONFIG, SUPCON_CONFIG, SEMIWEED_CONFIG, SELFSUP_CONFIG)},
        "slice_step_device_ms_per_step": {n: slice12[n]["device_ms"] for n in (
            ANGULAR_CONFIG, SUPCON_CONFIG, SEMIWEED_CONFIG, SELFSUP_CONFIG)},
        # phase 13: fcn32s (obia_CWFID.json, bf16), unimatch (f32) and
        # their drivers launch nothing; salientcps (f32): init, the warm-up
        # and timed steps, its driver epoch and the device time of one
        # profiled step; one step of vqunet_v1 and unetoriginal (sup, bf16)
        # and of nopt and scheme6 (cps, the flagship's config); the kernel
        # at salientcps's and vqunet_v1's shapes
        "launches_rest": {
            "obia_steps": rest["obia"]["launches"], "unimatch_steps": rest["unimatch"]["launches"],
            "unimatch_driver": rest["unimatch_driver"],
            "salientcps_init": rest["salientcps"]["init_launches"],
            "salientcps_steps": rest["salientcps"]["launches"],
            "salientcps_per_step": rest["salientcps"]["per_step"],
            "salientcps_driver": rest["salientcps_driver"],
            **{f"{n}_{k}": v[k] for n, v in rest["zoo"].items() for k in ("init", "step")}},
        "rest_step_device_ms": {k: rest[k]["device_ms"] for k in ("obia", "unimatch",
                                                                 "salientcps")},
        "rest_vq_device_ms_per_step": rest["salientcps"]["vq_ms"],
        "rest_shapes": [{key: r[key] for key in shape_keys} for r in rest["cases"]],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
