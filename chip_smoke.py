#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vq_seg_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when a
check does not hold:

1. device: a CUDA card is required; prints the ``nvidia-smi`` name and
   power limit.  TF32 is turned off for matmuls and cuDNN so that the f32
   comparisons below are f32.
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
   encoders cannot be fetched).  The init phase, then 3 warm-up and 20
   timed steps on distinct synthetic batches, each ended by a fetch of the
   loss: p50/p90 ms per step, img/s (8 images per step), every loss term,
   the peak memory and a profile of 5 more steps.  The kernel's launch
   count must be 18 per step (6 forwards x 3 VQ stages); losses finite,
   parameters and BN running stats changed, codebooks bitwise unchanged.
   The kernel is held against its plain version at the three shapes of a
   train pass, and one f32 step from the post-init state with VQ on the
   kernel is held against the same step with VQ on the plain version
   (near-tie rows given the kernel's code, as in phase 5): loss terms
   within 1e-4 relative, every parameter's gradient within 1e-3 relative
   L2.
7. one ``{"kernels": [...]}`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Imports only the port, torch, numpy and the standard library.
"""
from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "config", "vqreptunet1x1v2.json")
SEED = 0
BATCH = 8
PARTIAL = 3
STREAM_BATCHES = 3
# 110 timed calls leave 11 samples above the p90 that is reported
TIMED_BATCHES = 110
THROUGHPUT_BATCHES = 30
PROFILED_BATCHES = 5
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
E2E_TOL = 1e-3
TRAIN_BATCH = 4  # labeled, and as many unlabeled
TRAIN_WARMUP = 3
# 20 timed steps leave 2 samples above the p90 that is reported
TRAIN_TIMED = 20
TRAIN_PROFILED = 5
VQ_PER_STEP = 18  # 6 forwards x 3 VQ stages
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 1e-3
LOSS_TERMS = ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "commitment_loss",
              "prototype_loss")
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
    time, per ``unit``.  Returns the VQ kernels' device ms per ``unit``, or
    None (and prints "not measured") when the trace holds no device
    activity."""
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
    return vq_us / per


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


def train_batches(rng, n: int, hw: int):
    """``n`` distinct (labeled uint8 images, labels, unlabeled uint8 images)
    batches on the card.  Labels are vertical stripes a sixth of the width
    wide, each pixel shifted by 0 or 1 class at random, so that every class
    appears in every image."""
    stripes = (np.arange(hw) * 6 // hw)[None, None, :]
    out = []
    for _ in range(n):
        l_img = rng.integers(0, 256, size=(TRAIN_BATCH, hw, hw, 3), dtype=np.uint8)
        target = (stripes + rng.integers(0, 2, size=(TRAIN_BATCH, hw, hw))) % 3
        ul_img = rng.integers(0, 256, size=(TRAIN_BATCH, hw, hw, 3), dtype=np.uint8)
        out.append(tuple(torch.from_numpy(a).cuda() for a in (l_img, target, ul_img)))
    return out


def to_input(img_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 on the card -> (B, 3, H, W) f32 in [0, 1]."""
    return img_u8.permute(0, 3, 1, 2).float() / 255.0


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
    vq_ms_per_step = profile_window(lambda i: run_step(TRAIN_WARMUP + TRAIN_TIMED + i),
                                    TRAIN_PROFILED, "step", "train-profile",
                                    f"bf16 CPS step, batch {TRAIN_BATCH}+{TRAIN_BATCH}", card)

    # the kernel at the three shapes of a train pass
    dispatch = vector_quantizer.vq_assign
    captured = []

    def recording_vq_assign(x, codebook, metric="euclidean"):
        captured.append((x.detach().clone(), codebook.clone(), metric))
        return dispatch(x, codebook, metric)

    probe = copy.deepcopy(state.model_1).train()
    l_img, target, _ = batches[1]
    vector_quantizer.vq_assign = recording_vq_assign
    try:
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16, enabled=half):
            probe(to_input(l_img), target, th, train=True)
    finally:
        vector_quantizer.vq_assign = dispatch
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
    # the plain version.  The step clears the gradients before its backward
    # and leaves them after it, so each parameter's .grad is the step's
    # gradient.
    del state
    step32 = make_cps_train_step(dice, half=False, **step_kw)
    kernel_state = copy.deepcopy(post_init)
    l_img, target, ul_img = batches[1]
    _, m_kernel, _, _ = step32(kernel_state, to_input(l_img), target, to_input(ul_img))
    substituted = []
    vector_quantizer.vq_assign = plain_vq_with_kernel_ties(vq_cuda, vq_assign_reference, substituted)
    try:
        _, m_plain, _, _ = step32(post_init, to_input(l_img), target, to_input(ul_img))
    finally:
        vector_quantizer.vq_assign = dispatch
    loss_err = max(abs(float(m_kernel[k]) - float(m_plain[k])) / max(abs(float(m_plain[k])), 1e-30)
                   for k in LOSS_TERMS)
    grad_err, worst = 0.0, ""
    for mk, mp in ((kernel_state.model_1, post_init.model_1),
                   (kernel_state.model_2, post_init.model_2)):
        plain_params = dict(mp.named_parameters())
        for name, p in mk.named_parameters():
            err = rel_l2(p.grad, plain_params[name].grad)
            if err > grad_err:
                grad_err, worst = err, name
    print(f"[train-e2e] f32 CPS step from the post-init state, VQ on the kernel vs on the plain "
          f"version: loss terms max relative difference {loss_err:.3e} (limit {STEP_LOSS_TOL}), "
          f"gradients max relative L2 {grad_err:.3e} at {worst} (limit {STEP_GRAD_TOL}); "
          f"near-tie rows given the kernel's code in the plain run, per VQ call: {substituted}")
    check(len(substituted) == VQ_PER_STEP, f"plain step made {len(substituted)} VQ calls")
    check(loss_err <= STEP_LOSS_TOL, f"f32 step loss terms differ by {loss_err}")
    check(grad_err <= STEP_GRAD_TOL, f"f32 step gradient of {worst} differs by {grad_err}")
    return {"launches": launches, "cases": cases, "vq_ms_per_step": vq_ms_per_step}


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
    dispatch = vector_quantizer.vq_assign
    captured = []

    def recording_vq_assign(x, codebook, metric="euclidean"):
        captured.append((x.clone(), codebook.clone(), metric))
        return dispatch(x, codebook, metric)

    vector_quantizer.vq_assign = recording_vq_assign
    try:
        pred.logits(torch.from_numpy(batches[0]).cuda())
    finally:
        vector_quantizer.vq_assign = dispatch
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

    # -- 7. result lines -----------------------------------------------------------
    main_path = results[:len(captured)]  # the three shapes the serving forward gave
    shape_keys = ("case", "n", "c", "k", "ms", "plain_ms", "bound_ms", "f32_simt_bound_ms",
                  "near_ties", "max_abs_err")
    kernels = [{
        "name": "vq_assign",
        "route": "cuda",
        "source": "vq_seg_tpu_torch/csrc/vq_assign.cu",
        "replaces": "vq_seg_tpu/ops/vq_pallas.py:37",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results + train["cases"]),
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
        "launches_per_step": VQ_PER_STEP,
        "train_device_ms_per_step": train["vq_ms_per_step"],
        "train_bound_ms_per_step": 6 * sum(r["bound_ms"] for r in train["cases"]),
        "train_shapes": [{key: r[key] for key in shape_keys} for r in train["cases"]],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
