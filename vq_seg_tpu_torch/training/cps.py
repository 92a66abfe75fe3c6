"""Cross Pseudo Supervision (CPS) training step of the flagship,
counterpart of the JAX package's ``training/cps.py`` (``CPSTrainState``,
``create_cps_state``, ``cps_init_phase`` and the unfused
``make_cps_train_step``).

One step, as in the JAX package:

  * two pseudo passes over the unlabeled batch, each model in eval mode
    (running BN stats) under ``torch.no_grad``;
  * four train-mode passes: model 1 then model 2 on the labeled batch (int
    gt), then each on the unlabeled batch with the *other* model's score
    map as gt; each model's BN running stats update sup pass first, then
    unsup pass;
  * CPS, supervised, commitment and prototype losses in f32, one backward
    through both models, then each optimizer's update at ``lr =
    schedule(updates applied so far)``;
  * metrics stay on the device: nothing in the step reads a value back to
    the host.

``half=True`` runs the six forwards under bf16 ``torch.autocast``; the VQ
assignment, the prototype loss, the commitment loss and every loss and
mask after the forwards are f32.  bf16 needs no gradient scaler.  The
models are put in the BN mode each pass needs and left in the mode they
were found in.

``grad_accum_steps`` k > 1 (``create_cps_state``) is the JAX package's
``optax.MultiSteps(adam, every_k_schedule=k)``: each step is a micro-step
whose gradient joins a running mean, and Adam updates on every k-th with
that mean.  The JAX package's stacked and fused step compositions batch
work for the TPU and are not ported (ROADMAP.md, queue 1, item 1).

The driver, ``train``, runs the step over epochs as the JAX package's
``train`` does: PNG loaders, the init phase on the first labeled batch of
a fresh run, per-epoch averages, ``evaluate`` on the test split,
checkpoints on ``ckpt_cadence``, resume and preemption.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
from itertools import cycle
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from ..data import BaseDataset, Loader
from ..device import resolve_device
from ..losses import cross_entropy_loss, make_loss
from ..metrics.measurement import confusion_matrix, miou
from ..models.layers import resize_bilinear
from ..models.modules.vector_quantizer import ema_updates
from ..models.networks import make_model
from ..parallel.collectives import all_gather, all_reduce_, backward, on_mesh
from ..parallel.mesh import Mesh
from ..parallel.zero import zero_adam
from ..utils import visualize
from ..utils.ckpoints import (fetch_ckpt_tree, latest_ckpt, load_full, save_ckpoints, save_tar,
                              wait_for_saves)
from ..utils.debug import enable_nan_debug, finite_or_raise
from ..utils.logger import Logger, list_to_separate_log
from ..utils.preemption import PreemptionGuard
from ..utils.seed import seed_everything
from ..utils.seg_tools import confidence_filtered_pseudo, img_to_label
from ..utils.torch_weights import load_encoder_weights, pretrained_encoder, resolve_pretrained
from ..utils.train_tools import reinit_modules
from .schedules import make_lr_schedule

IGNORE = 255


@dataclasses.dataclass
class CPSTrainState:
    """The two models, their optimizers, the LR schedule, the number of
    steps taken (micro-steps under gradient accumulation, as the JAX
    package's ``state.step`` counts them) and the accumulation's k.  On a
    pair-sharded mesh a rank holds one model and its optimizer, and the
    other two fields are None."""

    model_1: Optional[nn.Module]
    model_2: Optional[nn.Module]
    opt_1: Optional[torch.optim.Optimizer]
    opt_2: Optional[torch.optim.Optimizer]
    schedule: Callable[[int], float]
    step: int = 0
    grad_accum_steps: int = 1
    replicas_differed: int = 0  # tensors the start-up broadcast changed (mesh)

    @property
    def updates(self) -> int:
        """Optimizer updates applied: the count the LR schedule reads."""
        return self.step // self.grad_accum_steps

    def held(self) -> list:
        """(index, model, optimizer) of each model this process holds."""
        return [(i, m, o) for i, (m, o) in enumerate(((self.model_1, self.opt_1),
                                                     (self.model_2, self.opt_2)))
                if m is not None]


_ADAM = dict(lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


class MultiStepAdam(torch.optim.Adam):
    """``optax.MultiSteps(optax.adam(schedule), every_k_schedule=k)``: each
    ``step()`` adds the parameters' gradients to a running mean, ``acc +=
    (g - acc) / (mini_step + 1)``; on every k-th call Adam updates with the
    mean and the mean starts again from zero.  On the other calls the
    parameters and Adam's moments and step count do not move.  A parameter
    takes part in a micro-step when it has a gradient.

    ``state_dict()`` is Adam's with ``mini_step`` (the micro-steps in the
    running mean) and ``acc_grads`` (the means by parameter index, as
    ``state``), the two fields JAX's ``MultiStepsState`` adds, so that a
    resume lands mid-accumulation where it stopped.  ``adam`` overrides
    Adam's settings (ZeRO-1 passes its own, the same)."""

    def __init__(self, params, every_k: int, **adam):
        super().__init__(params, **{**_ADAM, **adam})
        self.every_k = every_k
        self.mini_step = 0
        self.acc_grads: dict = {}  # parameter -> running mean of its gradients

    def __getstate__(self):  # copies and pickles keep the accumulation
        return {**super().__getstate__(), "every_k": self.every_k,
                "mini_step": self.mini_step, "acc_grads": self.acc_grads}

    def _params(self) -> list:
        return [p for group in self.param_groups for p in group["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for p in self._params() if p.grad is not None]
        grads = [p.grad for p in params]
        accs = [self.acc_grads.setdefault(p, torch.zeros_like(p)) for p in params]
        diff = torch._foreach_sub(grads, accs)
        torch._foreach_div_(diff, self.mini_step + 1)
        torch._foreach_add_(accs, diff)
        self.mini_step = (self.mini_step + 1) % self.every_k
        if self.mini_step == 0:
            for p, acc in zip(params, accs):
                p.grad = acc
            super().step()
            for p, g in zip(params, grads):
                p.grad = g
            torch._foreach_zero_(accs)

    def state_dict(self) -> dict:
        sd = super().state_dict()
        index = {p: i for i, p in enumerate(self._params())}
        sd["mini_step"] = self.mini_step
        sd["acc_grads"] = {index[p]: acc for p, acc in self.acc_grads.items()}
        return sd

    def load_state_dict(self, state_dict: dict):
        state_dict = dict(state_dict)
        mini_step = int(state_dict.pop("mini_step", 0))
        accs = state_dict.pop("acc_grads", {})
        super().load_state_dict(state_dict)
        params = self._params()
        self.mini_step = mini_step
        self.acc_grads = {params[int(i)]: a.to(params[int(i)].device, params[int(i)].dtype,
                                                copy=True)
                          for i, a in accs.items()}


def _adam(params, grad_accum_steps: int = 1, zero_group=None) -> torch.optim.Optimizer:
    """``optax.adam(schedule, b1=0.9, b2=0.999)``: eps 1e-8, no weight decay;
    the step writes the rate into the param groups before each update.
    With ``grad_accum_steps`` > 1, wrapped as ``optax.MultiSteps``; with a
    ``zero_group``, ZeRO-1 over it (``parallel/zero.py``)."""
    if zero_group is not None:
        return zero_adam(params, zero_group, grad_accum_steps, **_ADAM)
    if grad_accum_steps > 1:
        return MultiStepAdam(params, grad_accum_steps)
    return torch.optim.Adam(params, **_ADAM)


@torch.no_grad()
def broadcast_parameters_(module: nn.Module, mesh: Mesh) -> int:
    """Broadcast ``module``'s parameters and buffers from the first rank of
    this rank's data group (every member must call it); returns how many
    tensors the broadcast changed here."""
    src = mesh.rank_of(0, mesh.model_index)
    changed = 0
    for t in list(module.parameters()) + list(module.buffers()):
        sent = t.detach().clone()
        torch.distributed.broadcast(sent, src, group=mesh.data_group)
        if not torch.equal(sent, t):
            changed += 1
            t.copy_(sent)
    return changed


def create_cps_state(model_cfg, schedule: Callable[[int], float], *, seed: int = 0,
                     encoder_weights: Optional[str] = None, init_weights: bool = False,
                     grad_accum_steps: int = 1, device="cuda", mesh: Optional[Mesh] = None,
                     zero: bool = False, replicas: bool = False) -> CPSTrainState:
    """Two models drawn from two generators seeded from ``seed``, each with
    its Adam (a ``MultiStepAdam`` with ``grad_accum_steps`` > 1).
    ``encoder_weights`` (a tag or a .pth path, ``utils/torch_weights.py``)
    loads the same pretrained encoder into both models; a tag that
    resolves to no file warns and leaves the drawn weights.  Then
    ``init_weights`` re-draws the decoder and head convs of each model
    from its own generator, as the JAX package does after its encoder
    load.

    With a ``mesh`` each rank draws the models it holds (both, or on a
    pair-sharded mesh model m+1 alone) from the same generators, and then
    takes the parameters and buffers of its data group's first rank
    (``broadcast_parameters_``; ``state.replicas_differed`` counts the
    tensors that the broadcast changed, 0 when the draws agreed).
    ``replicas``: every rank holds both models whatever the ``model`` axis
    (the variant steps, whose ``model`` axis holds replicas).  ``zero``
    shards each Adam (a ``MultiStepAdam`` with accumulation) over the
    model's data group (ZeRO-1)."""
    device = resolve_device(device)
    pretrained = (resolve_pretrained(encoder_weights, model_cfg["params"].get("encoder_name"))
                  if encoder_weights else None)
    models, opts, differed = [], [], 0
    for i in range(2):
        if mesh is not None and mesh.pair and not replicas and i != mesh.model_index:
            models.append(None)
            opts.append(None)
            continue
        generator = torch.Generator().manual_seed(2 * seed + i)
        model = make_model(model_cfg, device="cpu", generator=generator)
        if pretrained is not None:
            load_encoder_weights(pretrained_encoder(model), pretrained)
        if init_weights:
            reinit_modules([model.core.decoder, model.segmentation_head], generator)
        model = model.to(device).train()
        if mesh is not None:
            differed += broadcast_parameters_(model, mesh)
        models.append(model)
        opts.append(_adam(model.parameters(), grad_accum_steps,
                          mesh.data_group if zero and mesh is not None else None))
    return CPSTrainState(models[0], models[1], opts[0], opts[1], schedule,
                         grad_accum_steps=grad_accum_steps, replicas_differed=differed)


def cps_init_phase(state: CPSTrainState, l_img: torch.Tensor, l_target: torch.Tensor,
                   extra: float, *, seed: int = 0, half: bool = False,
                   mesh: Optional[Mesh] = None) -> CPSTrainState:
    """The one-time data-dependent init on the first labeled batch: one
    train-mode forward of each model (batch-stat BN, running stats updated
    once) that sets its codebooks to the k-means of its encoder features,
    quantizes with them, and sets its prototype table to the k-means of the
    decoder output.  Each model draws from its own generator.  ``extra`` is
    the forward's third argument: the flagship's confidence threshold, or
    the ``reptcps`` networks' entropy percent (100 at init).

    With a ``mesh`` the ranks' shards are gathered over the data group into
    the global batch, and each rank runs the init of the models it holds
    on all of it, replicated: the running stats, codebooks and prototype
    tables are the single-process ones on every rank."""
    if mesh is not None:
        l_img = all_gather(l_img, mesh.data_group)
        l_target = all_gather(l_target, mesh.data_group)
    for i, model, _ in state.held():
        generator = torch.Generator().manual_seed(2 * seed + i)
        was_training = model.training
        model.train()
        with torch.no_grad(), ema_updates(), torch.autocast(l_img.device.type,
                                                            dtype=torch.bfloat16, enabled=half):
            model(l_img, l_target, extra, train=True, init_codebook=True, init_protos=True,
                  generator=generator)
        model.train(was_training)
    return state


def _apply_adam(state: CPSTrainState):
    """Each held optimizer's update at ``lr = schedule(updates applied so
    far)``, written into its param groups (a ZeRO wrapper hands them to its
    local Adam); then one more step taken."""
    lr = state.schedule(state.updates)
    for _, _, opt in state.held():
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    state.step += 1


def make_cps_train_step(dice_loss, *, num_classes: int, confidence_threshold: float = 0.7,
                        cps_loss_weight: float = 1.0, commitment_loss_weight: float = 1.0,
                        prototype_loss_weight: float = 0.01, ce_weight=None,
                        half: bool = False, mesh: Optional[Mesh] = None):
    """Build ``train_step(state, l_img, l_target, ul_img) -> (state, metrics,
    pred_sup_1, pred_ul_1)`` for (x, gt, th)-signature networks.  Images are
    (N, 3, H, W) floats, labels (N, H, W) integers; ``state`` is updated in
    place.  ``metrics`` holds device tensors: loss, cps_loss, sup_loss_1,
    sup_loss_2, commitment_loss, prototype_loss, miou, iou_list and
    code_usage.

    With a data-parallel ``mesh`` (``n_model`` 1) each rank passes its shard
    of the global batch: the forwards and losses run inside
    ``data_parallel`` over the data group, so every loss term and metric is
    the global batch's, the same on every rank; the two models' gradients
    are then averaged over the group in buckets, and each rank takes the
    same two Adam steps.  Predictions are this rank's rows."""
    th = confidence_threshold
    if mesh is not None and mesh.pair:
        raise ValueError("a pair-sharded mesh takes make_cps_train_step_pairsharded")

    def ce(pred, target):
        return cross_entropy_loss(pred, target, ignore_index=IGNORE, weight=ce_weight)

    @on_mesh(mesh)
    def train_step(state: CPSTrainState, l_img, l_target, ul_img):
        m1, m2 = state.model_1, state.model_2
        modes = (m1.training, m2.training)
        device_type = l_img.device.type
        try:
            m1.eval()
            m2.eval()
            with torch.no_grad(), torch.autocast(device_type, dtype=torch.bfloat16,
                                                 enabled=half):
                pseudo_1_score = m1(ul_img)[0]
                pseudo_2_score = m2(ul_img)[0]
            m1.train()
            m2.train()
            # an ema codebook updates after each train pass: the next pass
            # of the same model quantizes with it (sup 1, sup 2, unsup 1,
            # unsup 2)
            with ema_updates(), torch.autocast(device_type, dtype=torch.bfloat16,
                                               enabled=half):
                pred_sup_1, c_l1, u_l1, pl_l1 = m1(l_img, l_target, th, train=True)
                pred_sup_2, c_l2, u_l2, pl_l2 = m2(l_img, l_target, th, train=True)
                pred_ul_1, c_ul1, u_ul1, pl_ul1 = m1(ul_img, pseudo_2_score, th, train=True)
                pred_ul_2, c_ul2, u_ul2, pl_ul2 = m2(ul_img, pseudo_1_score, th, train=True)
        finally:
            m1.train(modes[0])
            m2.train(modes[1])

        pred_1 = torch.cat([pred_sup_1, pred_ul_1]).float()
        pred_2 = torch.cat([pred_sup_2, pred_ul_2]).float()
        with torch.no_grad():
            filt_1 = confidence_filtered_pseudo(pred_1, torch.argmax(pred_1, dim=1), th,
                                                IGNORE)
            filt_2 = confidence_filtered_pseudo(pred_2, torch.argmax(pred_2, dim=1), th,
                                                IGNORE)
        cps_loss = (0.5 * ce(pred_1, filt_2) + 0.5 * ce(pred_2, filt_1)
                    + dice_loss(pred_1, filt_2) + dice_loss(pred_2, filt_1))
        sup_loss_1 = 0.5 * ce(pred_sup_1, l_target) + dice_loss(pred_sup_1, l_target)
        sup_loss_2 = 0.5 * ce(pred_sup_2, l_target) + dice_loss(pred_sup_2, l_target)
        commitment = (c_l1 + c_l2 + c_ul1 + c_ul2) * commitment_loss_weight
        prototype = (pl_l1 + pl_l2 + pl_ul1 + pl_ul2) * prototype_loss_weight
        loss = sup_loss_1 + sup_loss_2 + cps_loss_weight * cps_loss + commitment + prototype

        state.opt_1.zero_grad(set_to_none=True)
        state.opt_2.zero_grad(set_to_none=True)
        backward(loss, m1, m2)
        _apply_adam(state)

        with torch.no_grad():
            step_miou, iou_list = miou(confusion_matrix(pred_sup_1, l_target, num_classes))
            metrics = dict(loss=loss.detach(), cps_loss=cps_loss.detach(),
                           sup_loss_1=sup_loss_1.detach(), sup_loss_2=sup_loss_2.detach(),
                           commitment_loss=commitment.detach(),
                           prototype_loss=prototype.detach(), miou=step_miou,
                           iou_list=iou_list,
                           code_usage=(u_l1 + u_l2 + u_ul1 + u_ul2) / 4.0)
        return state, metrics, pred_sup_1.detach(), pred_ul_1.detach()

    return train_step


def make_cps_train_step_pairsharded(dice_loss, mesh: Mesh, *, num_classes: int,
                                    confidence_threshold: float = 0.7,
                                    cps_loss_weight: float = 1.0,
                                    commitment_loss_weight: float = 1.0,
                                    prototype_loss_weight: float = 0.01, ce_weight=None,
                                    half: bool = False):
    """The CPS step with each model on its own ranks, the JAX package's
    ``make_cps_train_step_pairsharded``: rank (d, m) holds model m+1 and the
    shard d of the global batch.

      * its model's eval-mode pseudo scores are swapped with the partner
        rank (d, 1-m) (an all-gather on the pair group, JAX's
        ``ppermute``): each model trains its unlabelled pass on the other's;
      * the confidence-filtered CPS targets are swapped the same way and
        enter the loss without gradient;
      * each rank differentiates its own model's terms, over the global
        batch of its data group (``data_parallel``, sync-BN included),
        averages the gradients over that group and takes its own Adam step;
      * the metrics sum the pair's terms (JAX's ``psum`` over ``model``):
        one all-gather of the scalars on the pair group.  ``miou`` and
        ``iou_list`` are model 1's, as in the single-process step.

    Returns ``(state, metrics, pred_sup, pred_ul)`` with this rank's model's
    predictions of its rows."""
    th = confidence_threshold
    m = mesh.model_index

    def ce(pred, target):
        return cross_entropy_loss(pred, target, ignore_index=IGNORE, weight=ce_weight)

    def swap(t):
        """The partner's ``t`` (same shape), over the pair group."""
        return all_gather(t, mesh.pair_group).chunk(2)[1 - m]

    @on_mesh(mesh)
    def train_step(state: CPSTrainState, l_img, l_target, ul_img):
        [(_, model, opt)] = state.held()
        was_training = model.training
        device_type = l_img.device.type
        try:
            model.eval()
            with torch.no_grad(), torch.autocast(device_type, dtype=torch.bfloat16,
                                                 enabled=half):
                pseudo_other = swap(model(ul_img)[0])
            model.train()
            with ema_updates(), torch.autocast(device_type, dtype=torch.bfloat16,
                                               enabled=half):
                pred_sup, c_l, u_l, pl_l = model(l_img, l_target, th, train=True)
                pred_ul, c_ul, u_ul, pl_ul = model(ul_img, pseudo_other, th, train=True)
        finally:
            model.train(was_training)

        pred = torch.cat([pred_sup, pred_ul]).float()
        with torch.no_grad():
            filt_other = swap(confidence_filtered_pseudo(pred, torch.argmax(pred, dim=1),
                                                         th, IGNORE))
        cps_mine = 0.5 * ce(pred, filt_other) + dice_loss(pred, filt_other)
        sup_mine = 0.5 * ce(pred_sup, l_target) + dice_loss(pred_sup, l_target)
        commit_mine = (c_l + c_ul) * commitment_loss_weight
        proto_mine = (pl_l + pl_ul) * prototype_loss_weight
        loss_mine = sup_mine + cps_loss_weight * cps_mine + commit_mine + proto_mine

        opt.zero_grad(set_to_none=True)
        backward(loss_mine, model)
        _apply_adam(state)

        with torch.no_grad():
            step_miou, iou_list = miou(confusion_matrix(pred_sup, l_target, num_classes))
            mine = torch.cat([torch.stack([sup_mine, cps_mine, commit_mine, proto_mine,
                                           step_miou]).float(), iou_list.float(),
                              (u_l + u_ul).float()])
            pair = all_gather(mine[None], mesh.pair_group)  # row m: model m+1's
            sup, cps, commit, proto = pair[:, 0], pair[:, 1], pair[:, 2], pair[:, 3]
            k = iou_list.shape[0]
            cps_loss = cps[0] + cps[1]
            metrics = dict(loss=torch.sum(sup + commit + proto) + cps_loss_weight * cps_loss,
                           cps_loss=cps_loss, sup_loss_1=sup[0], sup_loss_2=sup[1],
                           commitment_loss=commit[0] + commit[1],
                           prototype_loss=proto[0] + proto[1], miou=pair[0, 4],
                           iou_list=pair[0, 5:5 + k],
                           code_usage=(pair[0, 5 + k:] + pair[1, 5 + k:]) / 4.0)
        return state, metrics, pred_sup.detach(), pred_ul.detach()

    return train_step


@torch.no_grad()
def evaluate(model, loader, pixel_to_label, num_classes: int, *, half: bool = False,
             device="cuda") -> float:
    """Mean per-image mIoU over a test loader by the official protocol
    (reference test_detailviz.py:107-145): targets at native size, logits
    bilinearly resized to the mask size before the argmax, so that
    in-training curves compare with the test CLI's.  ``loader`` yields
    batches of one image, as tensors (``Loader(device=...)``) or as host
    numpy (NHWC).  The model runs in eval mode and is left in the mode it
    was found in; the sum stays on the device and is read once."""
    device = resolve_device(device)
    was_training = model.training
    model.eval()
    total = torch.zeros((), dtype=torch.float64, device=device)
    n = 0
    try:
        for batch in loader:
            img, target = batch["img"], batch["target"]
            if isinstance(img, np.ndarray):
                img = torch.from_numpy(img).permute(0, 3, 1, 2)
                target = torch.from_numpy(target)
            img, target = img.to(device), target.to(device)
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=half):
                out = model(img)
            pred = (out[0] if isinstance(out, tuple) else out).float()
            target = img_to_label(target, pixel_to_label)
            if pred.shape[-2:] != target.shape[-2:]:
                pred = resize_bilinear(pred, target.shape[-2:])
            m, _ = miou(confusion_matrix(pred, target, num_classes))
            total += m.double()
            n += 1
    finally:
        model.train(was_training)
    return float(total) / max(n, 1)


def ckpt_cadence(cfg, epoch: int, num_epochs: int):
    """Checkpoint-cadence decision for one epoch: ``(do_snap, do_last,
    light)``.

    * ``cfg.train.ckpt_every``: the ``last.ckpt`` cadence (the reference
      writes every epoch).  Snapshots (``{N}ep.ckpt``) keep the reference
      10-epoch cadence or ``ckpt_every``, whichever is coarser.
    * ``cfg.train.last_every``: decouples the full-contract ``last.ckpt``
      from snapshots (defaults to ``ckpt_every``).
    * ``cfg.train.light_snapshots``: snapshots keep models only (the eval
      sweep reads ``model_1``); ``last.ckpt`` always keeps the full
      contract.
    The final epoch always writes both."""
    ckpt_every = int(cfg.train.get("ckpt_every", 1) or 1)
    snap_every = max(10, ckpt_every)
    last_every = int(cfg.train.get("last_every", ckpt_every) or ckpt_every)
    final = epoch == num_epochs - 1
    do_snap = epoch % snap_every == 0 or final
    do_last = epoch % last_every == 0 or final
    light = bool(cfg.train.get("light_snapshots", False))
    return do_snap, do_last, light


def _adam_step(opt_state: dict) -> int:
    """The optimizer steps taken, from Adam's per-parameter ``step``."""
    for s in opt_state.get("state", {}).values():
        return int(s["step"])
    return 0


def restore_cps_state(state: CPSTrainState, ck: dict) -> CPSTrainState:
    """Load a checkpoint contract into ``state``: the models it holds and,
    unless it is a light snapshot, their optimizers (a ZeRO wrapper keeps
    its shard of the full state), and ``state.step`` from Adam's
    per-parameter step count (the updates) times ``grad_accum_steps`` plus
    the micro-steps of the running mean, so that the LR continues at
    ``schedule(updates)``.  The contract stores no step of its own."""
    full = ck.get("optimizer_1") is not None
    for i, model, opt in state.held():
        model.load_state_dict(ck[f"model_{i + 1}"])
        if full:  # a ZeRO wrapper writes None over the other ranks' entries: give it a copy
            sd = ck[f"optimizer_{i + 1}"]
            opt.load_state_dict({**sd, "state": dict(sd["state"])})
    if full:
        state.step = (_adam_step(ck["optimizer_1"]) * state.grad_accum_steps
                      + int(ck["optimizer_1"].get("mini_step", 0)))
    else:
        print("resume: the checkpoint has no optimizer state (a light snapshot): "
              "continuing with fresh Adam moments from step 0")
    return state


def mesh_ckpt_tree(state: CPSTrainState, mesh: Mesh, epoch: int, batch_idx: int,
                   include_optimizers: bool = True) -> Optional[dict]:
    """The checkpoint contract of a mesh's state, on the host of its main
    rank (None on the others), the same contract a single process writes.
    Every rank of the mesh calls it: a ZeRO optimizer consolidates its
    state on its data group's first rank (a collective), and on a
    pair-sharded mesh rank (0, 1) sends model 2's part to rank (0, 0)."""
    if include_optimizers:
        for _, _, opt in state.held():
            if hasattr(opt, "consolidate_state_dict"):
                opt.consolidate_state_dict(to=0)
    if mesh.data_index != 0:
        return None
    part = {}
    for i, model, opt in state.held():
        part[f"model_{i + 1}"] = model.state_dict()
        if include_optimizers:
            part[f"optimizer_{i + 1}"] = opt.state_dict()
    part = fetch_ckpt_tree(**{"model_1": None, "model_2": None, "optimizer_1": None,
                              "optimizer_2": None, **part}, epoch=epoch, batch_idx=batch_idx,
                           include_optimizers=include_optimizers)
    if mesh.pair:
        sent = [part if mesh.model_index == 1 else None]
        torch.distributed.broadcast_object_list(sent, mesh.rank_of(0, 1),
                                                group=mesh.pair_group)
        if mesh.model_index == 0:
            part.update({k: v for k, v in sent[0].items() if k.endswith("_2")})
    return part if mesh.is_main else None


def model_cfg_with_bn(cfg):
    """``cfg.model`` with ``cfg.train.bn_eps``/``bn_momentum`` passed to the
    network, whose decoder takes them as constructor arguments."""
    model_cfg = copy.deepcopy(cfg.model)
    for key in ("bn_eps", "bn_momentum"):
        if cfg.train.get(key) is not None:
            model_cfg["params"][key] = cfg.train[key]
    return model_cfg


def run_dir(cfg, tag: str) -> Optional[str]:
    """``{save_dir}/{project_name}_{tag}_{n}`` with ``ckpoints/`` (n = the
    entries already in ``save_dir``), or None without ``cfg.train.save_dir``."""
    if not cfg.train.get("save_dir"):
        return None
    os.makedirs(cfg.train.save_dir, exist_ok=True)
    name = f"{cfg.project_name}_{tag}_{len(os.listdir(cfg.train.save_dir))}"
    save_dir = os.path.join(cfg.train.save_dir, name)
    os.makedirs(os.path.join(save_dir, "ckpoints"))
    return save_dir


def epoch_summary(tag: Optional[str], epoch: int, sums: dict, n: int, seconds: float) -> tuple:
    """Per-epoch averages of the device sums, read once: ``iou_list``
    dropped, vectors (``code_usage``) averaged to a scalar, keys in sorted
    order as the JAX package's jitted metrics come back.  Returns (averages,
    the ``[{tag}][Epoch{e}] k=v, ...`` line)."""
    avg = {k: float(np.mean((sums[k] / n).cpu().numpy())) for k in sorted(sums)
           if k != "iou_list"}
    prefix = f"[{tag}][Epoch{epoch}] " if tag else f"[Epoch{epoch}] "
    line = prefix + ", ".join(f"{k}={v:.4f}" for k, v in avg.items()) + f", {seconds:.1f}s"
    return avg, line


def semi_loaders(cfg, device, shard: Optional[tuple] = None):
    """The labelled and unlabelled training loaders, seeds 0 and 1.
    workers=4 spreads the cold epoch's PNG decode; the RAM cache serves the
    later epochs.  ``shard`` (data index, data ranks): each global batch of
    ``cfg.train.batch_size`` yields this rank's rows only."""
    root = os.path.join(cfg.train.data_dir, "train")
    bs = cfg.train.batch_size
    sup = BaseDataset(root, "labelled", batch_size=bs, resize=cfg.resize)
    unsup = BaseDataset(root, "unlabelled", batch_size=bs, resize=cfg.resize)
    return (Loader(sup, bs, shuffle=True, seed=0, device=device, workers=4, shard=shard),
            Loader(unsup, bs, shuffle=True, seed=1, device=device, workers=4, shard=shard))


def make_test_loader(cfg, device):
    """The test split by the official protocol (inputs resized, targets at
    native size), or None without ``cfg.test`` and ``cfg.train.test_every``."""
    if not (cfg.get("test") and cfg.train.get("test_every")):
        return None
    ds = BaseDataset(os.path.join(cfg.test.data_dir, "test"), "labelled", batch_size=1,
                     resize=cfg.resize, target_resize=False)
    return Loader(ds, 1, shuffle=False, device=device)


def _check_supported(cfg):
    """Knobs of the JAX driver that batch work for the TPU raise here."""
    tc = cfg.train
    unported = [
        (int(tc.get("scan_steps", 0) or 0) > 1, "scan_steps > 1", "item 1"),
        (bool(tc.get("fused_step")), "fused_step", "item 1"),
    ]
    for on, name, item in unported:
        if on:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md, queue 1, {item})")


def _mesh_flag(mesh: Mesh, flag: bool) -> bool:
    """``flag`` set on any rank of the mesh (an all-reduce MAX)."""
    device = "cuda" if mesh.backend == "nccl" else "cpu"
    t = torch.tensor([int(flag)], device=device)
    return bool(all_reduce_(t, mesh.group, torch.distributed.ReduceOp.MAX).item())


def _from_main(mesh: Optional[Mesh], value):
    """``value`` as the mesh's main rank holds it, on every rank."""
    if mesh is None:
        return value
    box = [value]
    torch.distributed.broadcast_object_list(box, mesh.ranks[0], group=mesh.group)
    return box[0]


def _to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).cpu().numpy()


def train(cfg, max_steps_per_epoch: Optional[int] = None, preempt=None, device="cuda",
          mesh: Optional[Mesh] = None, history: Optional[list] = None) -> CPSTrainState:
    """The flagship CPS driver, the JAX package's ``train`` (reference
    train_vqreptunet1x1v2.py:48-274).  Returns the final state.

    * Data: ``{cfg.train.data_dir}/train`` labelled and unlabelled loaders
      (seeds 0 and 1, the labelled one cycled), ``steps_per_epoch`` =
      batches of the unlabelled loader, capped by ``max_steps_per_epoch``;
      the LR schedule spans the uncapped count.
    * With ``cfg.train.save_dir``: a run directory
      ``{project_name}_hybrid_{n}`` with ``log_txt``, ``ckpoints/``
      (``{N}ep.ckpt`` and ``last.ckpt`` on ``ckpt_cadence``), ``imgs/`` and
      the logger's JSONL file.
    * ``cfg.train.resume``: a checkpoint path, or "auto" for the newest
      run's ``last.ckpt``; the run continues at the saved epoch + 1 with
      models, optimizers and step restored.  The init phase runs only on
      the first labelled batch of a fresh run.
    * ``preempt``: a ``PreemptionGuard`` (by default the driver installs
      its own, which latches SIGTERM); once it is set, the epoch ends with
      a full-contract ``last.ckpt`` and the driver returns.
    * ``cfg.train.grad_accum_steps`` k: each step is a micro-step and the
      optimizers update on every k-th with the mean gradient
      (``MultiStepAdam``, the JAX package's ``optax.MultiSteps``); the LR
      inside Adam is ``schedule(updates)`` and the logged ``lr``
      ``schedule(micro-steps - 1)``, as the JAX package has them.
    * ``cfg.train.debug_nans``: anomaly mode (``enable_nan_debug``) while
      the driver runs, put back as it was when it returns, and each step's
      loss checked with ``finite_or_raise`` (one read of the card per
      step).  A backward function that returns NaN raises
      ``RuntimeError``, a non-finite loss ``FloatingPointError``.
    * ``cfg.train.remat`` is accepted and has no effect: it trades memory
      only, and the flagship step peaks at 8.96 GiB of 80 GB on an NVIDIA
      H100 80GB HBM3 at 700.00 W (PERF.md).  ``scan_steps`` and
      ``fused_step`` raise.
    * ``mesh`` (``parallel.make_mesh``; every rank of it calls ``train``):
      ``cfg.train.batch_size`` is the global batch, and each rank decodes
      its shard of every global batch from the same seeded order.  A mesh
      with ``n_model`` 1 runs the data-parallel step, with 2 the
      pair-sharded step; ``cfg.train.zero_opt`` shards each Adam over its
      model's data group (ZeRO-1), with ``grad_accum_steps`` too.  The
      init phase runs on the gathered global batch.  Rank (0, 0) alone
      logs, evaluates model 1 (the others wait for its mIoU), writes the
      run directory and writes each checkpoint, the single-process
      contract gathered from the ranks.
      A preemption latched on any rank stops every rank after the same
      epoch.  ``history`` gets the same records on every rank.
    """
    device = resolve_device(device)
    _check_supported(cfg)
    seed_everything()
    main = mesh is None or mesh.is_main
    num_classes = cfg.num_classes
    num_epochs = cfg.train.num_epochs
    half = bool(cfg.train.get("half", False))
    p2l = cfg.pixel_to_label

    # the run directory and checkpoints are keyed on save_dir alone (the
    # reference gated both on wandb_logging, so logging-off runs saved
    # nothing)
    logger = None
    ckpoints_dir = img_dir = log_txt = None
    save_dir = run_dir(cfg, "hybrid") if main else None
    if save_dir is not None:
        logger_name = os.path.basename(save_dir)
        ckpoints_dir = os.path.join(save_dir, "ckpoints")
        if cfg.train.save_img:
            img_dir = os.path.join(save_dir, "imgs")
            os.mkdir(img_dir)
        log_txt = os.path.join(save_dir, "log_txt")
        open(log_txt, "w").close()
        if cfg.wandb_logging:
            logger = Logger(cfg, logger_name, offline_dir=save_dir)

    shard = (mesh.data_index, mesh.n_data) if mesh is not None else None
    sup_loader, unsup_loader = semi_loaders(cfg, device, shard)
    steps_per_epoch = len(unsup_loader)
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)

    schedule = make_lr_schedule(cfg.train, len(unsup_loader))
    criterion = cfg.train.criterion
    dice = make_loss(criterion.name, num_classes, ignore_index=IGNORE,
                     weight=criterion.get("weight"))
    th = cfg.train.confidence_threshold
    state = create_cps_state(model_cfg_with_bn(cfg), schedule,
                             encoder_weights=cfg.model.params.get("encoder_weights"),
                             init_weights=bool(cfg.train.get("init_weights", False)),
                             grad_accum_steps=int(cfg.train.get("grad_accum_steps", 1) or 1),
                             device=device, mesh=mesh,
                             zero=bool(cfg.train.get("zero_opt")) and mesh is not None)
    if state.replicas_differed:
        print(f"rank {mesh.rank}: the start-up broadcast changed {state.replicas_differed} "
              "tensors: the ranks' draws differed")
    debug_nans = bool(cfg.train.get("debug_nans"))
    step_kw = dict(num_classes=num_classes, confidence_threshold=th,
                   cps_loss_weight=cfg.train.cps_loss_weight,
                   commitment_loss_weight=cfg.train.total_commitment_loss_weight,
                   prototype_loss_weight=cfg.train.total_prototype_loss_weight,
                   ce_weight=criterion.get("weight"), half=half)
    if mesh is not None and mesh.pair:
        train_step = make_cps_train_step_pairsharded(dice, mesh, **step_kw)
    else:
        train_step = make_cps_train_step(dice, mesh=mesh, **step_kw)

    start_epoch, initted = 0, False
    resume = cfg.train.get("resume")
    if resume == "auto":
        resume = _from_main(mesh, latest_ckpt(cfg.train.get("save_dir")) if main else None)
        if main:
            print(f"auto-resume: {resume or 'no previous last.ckpt, fresh start'}")
    if resume:
        ck = load_full(resume)
        restore_cps_state(state, ck)
        start_epoch = int(ck["epoch"]) + 1
        initted = True
        if main:
            print(f"resume: {resume}: epoch {start_epoch}, step {state.step}, "
                  f"lr {schedule(state.step)}")

    test_loader = make_test_loader(cfg, device) if main else None
    test_every = cfg.train.get("test_every") if cfg.get("test") else None

    l_input = l_target = ul_input = pred_sup_1 = pred_ul_1 = None
    with (preempt or PreemptionGuard()) as preempt, \
            (enable_nan_debug() if debug_nans else contextlib.nullcontext()):
        for epoch in range(start_epoch, num_epochs):
            trainloader = zip(cycle(iter(sup_loader)), iter(unsup_loader))
            sums: dict = {}
            ep_start = time.time()
            step_start = state.step
            for batch_idx in range(steps_per_epoch):
                sup_batch, unsup_batch = next(trainloader)
                l_input = sup_batch["img"]
                l_target = img_to_label(sup_batch["target"], p2l)
                ul_input = unsup_batch["img"]
                if not initted:
                    cps_init_phase(state, l_input, l_target, th, half=half, mesh=mesh)
                    initted = True
                state, metrics, pred_sup_1, pred_ul_1 = train_step(state, l_input, l_target,
                                                                   ul_input)
                if debug_nans:
                    finite_or_raise({"loss": metrics["loss"]}, f"step {state.step - 1}")
                for k, v in metrics.items():  # on the device, read once per epoch
                    sums[k] = sums.get(k, 0) + v
            del trainloader  # ends the loaders' threads of a capped epoch
            stop = _mesh_flag(mesh, preempt.should_stop) if mesh is not None \
                else preempt.should_stop
            avg = {k: (v / steps_per_epoch).cpu().numpy() for k, v in sums.items()}
            iou = avg.pop("iou_list")
            back_iou, weed_iou, crop_iou = [float(x) for x in iou[:3]]
            code_usage = [float(x) for x in np.atleast_1d(avg.pop("code_usage"))]
            lr = float(schedule(int(state.step) - 1))
            seconds = time.time() - ep_start
            print_txt = (f"[Epoch{epoch}] miou={avg['miou']:.4f}, "
                         f"sup_loss_1={avg['sup_loss_1']:.4f}, "
                         f"prototype_loss={avg['prototype_loss']:.4f}, "
                         f"cps_loss={avg['cps_loss']:.4f}, "
                         f"commitment_loss={avg['commitment_loss']:.4f}, "
                         f"{seconds:.1f}s")
            if main:
                print(print_txt)
            record = {"epoch": epoch, "seconds": seconds, "steps": steps_per_epoch,
                      "step_start": step_start,
                      "lr_start": float(schedule(step_start // state.grad_accum_steps)),
                      "step": state.step, "lr": lr, "iou_list": [float(x) for x in iou],
                      "code_usage": code_usage, "test_miou": None, "eval_seconds": None,
                      "ckpt_fetch_seconds": None, "ckpt_files": [],
                      **{k: float(v) for k, v in avg.items()}}
            if test_every and epoch % test_every == 0:
                t0 = time.time()
                test_miou = None
                if test_loader is not None:  # model 1 lives on the main rank
                    test_miou = evaluate(state.model_1, test_loader, p2l, num_classes,
                                         half=half, device=device)
                test_miou = _from_main(mesh, test_miou)
                record.update(test_miou=test_miou, eval_seconds=time.time() - t0)
                if main:
                    print(f"test miou : {test_miou}")
                if logger is not None:
                    logger.log_dict["test_miou"] = test_miou
            if log_txt is not None:
                with open(log_txt, "a") as f:
                    f.write(print_txt + "\n")
            if cfg.train.get("save_dir"):
                if save_dir is not None:
                    example = visualize.make_example_img(
                        _to_nhwc(l_input), l_target.cpu().numpy(), _to_nhwc(pred_sup_1),
                        _to_nhwc(ul_input), _to_nhwc(pred_ul_1))
                    if logger is not None:
                        logger.image_update(example, f"{epoch}ep")
                    if cfg.train.save_img:
                        visualize.save_img(img_dir, f"output_{epoch}ep.png", example)
                do_snap, do_last, light = ckpt_cadence(cfg, epoch, num_epochs)
                if stop:
                    # preemption: last.ckpt carries the full resume contract
                    # whatever the cadence
                    do_last = True
                if do_snap or do_last:
                    t0 = time.time()
                    # one host copy shared by the snapshot and last.ckpt
                    full = do_last or not light
                    if mesh is None:
                        host_ck = fetch_ckpt_tree(state.model_1, state.model_2, epoch,
                                                  batch_idx, state.opt_1, state.opt_2,
                                                  include_optimizers=full)
                    else:
                        host_ck = mesh_ckpt_tree(state, mesh, epoch, batch_idx, full)
                    record["ckpt_fetch_seconds"] = time.time() - t0
                    # snapshots may be light; last.ckpt keeps the full contract
                    writes = [(f"{epoch}ep.ckpt", not light)] if do_snap else []
                    writes += [("last.ckpt", True)] if do_last else []
                    for name, with_opt in writes:
                        if host_ck is not None:
                            save_ckpoints(None, None, epoch, batch_idx, None, None,
                                          os.path.join(ckpoints_dir, name), prefetched=host_ck,
                                          include_optimizers=with_opt)
                        record["ckpt_files"].append(name)
            if logger is not None:
                logger.log_dict.update({k: float(v) for k, v in avg.items()})
                logger.log_dict.update(dict(back_iou=back_iou, weed_iou=weed_iou,
                                            crop_iou=crop_iou, learning_rate=lr))
                logger.temp_update(list_to_separate_log(code_usage, "code_usage"))
                logger.logging(epoch=epoch)
                logger.config_update()
            if history is not None:
                history.append(record)
            if stop:
                if main:
                    print(f"preempted after epoch {epoch}: last.ckpt written; rerun with "
                          "cfg.train.resume='auto' to continue")
                break
    if logger is not None:
        logger.finish()
    if save_dir is not None:
        wait_for_saves()  # the write in flight
        if cfg.train.get("save_as_tar", False):
            save_tar(save_dir)
    return state
