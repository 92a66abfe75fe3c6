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
    schedule(step)``;
  * metrics stay on the device: nothing in the step reads a value back to
    the host.

``half=True`` runs the six forwards under bf16 ``torch.autocast``; the VQ
assignment, the prototype loss, the commitment loss and every loss and
mask after the forwards are f32.  bf16 needs no gradient scaler.  The
models are put in the BN mode each pass needs and left in the mode they
were found in.

The JAX package's stacked and fused step compositions batch work for the
TPU and are not ported (ROADMAP.md, queue 1, item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn as nn

from ..device import resolve_device
from ..losses import cross_entropy_loss
from ..metrics.measurement import confusion_matrix, miou
from ..models.networks import make_model
from ..utils.seg_tools import confidence_filtered_pseudo
from ..utils.train_tools import reinit_modules

IGNORE = 255


@dataclasses.dataclass
class CPSTrainState:
    """The two models, their optimizers, the LR schedule and the number of
    optimizer steps taken."""

    model_1: nn.Module
    model_2: nn.Module
    opt_1: torch.optim.Optimizer
    opt_2: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def _adam(params) -> torch.optim.Optimizer:
    """``optax.adam(schedule, b1=0.9, b2=0.999)``: eps 1e-8, no weight decay;
    the step writes the rate into the param groups before each update."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def create_cps_state(model_cfg, schedule: Callable[[int], float], *, seed: int = 0,
                     encoder_weights: Optional[str] = None, init_weights: bool = False,
                     device="cuda") -> CPSTrainState:
    """Two models drawn from two generators seeded from ``seed``, each with
    its Adam.  ``init_weights`` re-draws the decoder and head convs of each
    model from its own generator.
    Pretrained encoder weights cannot be loaded: a non-None
    ``encoder_weights`` raises."""
    if encoder_weights:
        raise NotImplementedError(
            f"pretrained encoder weights ({encoder_weights!r}) are not ported yet "
            "(ROADMAP.md, queue 1, 'Driver, evaluation and checkpoints'); pass "
            "encoder_weights=None for random weights")
    device = resolve_device(device)
    models = []
    for i in range(2):
        generator = torch.Generator().manual_seed(2 * seed + i)
        model = make_model(model_cfg, device="cpu", generator=generator)
        if init_weights:
            reinit_modules([model.core.decoder, model.segmentation_head], generator)
        models.append(model.to(device).train())
    return CPSTrainState(models[0], models[1], _adam(models[0].parameters()),
                         _adam(models[1].parameters()), schedule)


def cps_init_phase(state: CPSTrainState, l_img: torch.Tensor, l_target: torch.Tensor,
                   th: float, *, seed: int = 0, half: bool = False) -> CPSTrainState:
    """The one-time data-dependent init on the first labeled batch: one
    train-mode forward of each model (batch-stat BN, running stats updated
    once) that sets its codebooks to the k-means of its encoder features,
    quantizes with them, and sets its prototype table to the k-means of the
    decoder output.  Each model draws from its own generator."""
    for i, model in enumerate((state.model_1, state.model_2)):
        generator = torch.Generator().manual_seed(2 * seed + i)
        was_training = model.training
        model.train()
        with torch.no_grad(), torch.autocast(l_img.device.type, dtype=torch.bfloat16,
                                             enabled=half):
            model(l_img, l_target, th, train=True, init_codebook=True, init_protos=True,
                  generator=generator)
        model.train(was_training)
    return state


def make_cps_train_step(dice_loss, *, num_classes: int, confidence_threshold: float = 0.7,
                        cps_loss_weight: float = 1.0, commitment_loss_weight: float = 1.0,
                        prototype_loss_weight: float = 0.01, ce_weight=None,
                        half: bool = False):
    """Build ``train_step(state, l_img, l_target, ul_img) -> (state, metrics,
    pred_sup_1, pred_ul_1)`` for (x, gt, th)-signature networks.  Images are
    (N, 3, H, W) floats, labels (N, H, W) integers; ``state`` is updated in
    place.  ``metrics`` holds device tensors: loss, cps_loss, sup_loss_1,
    sup_loss_2, commitment_loss, prototype_loss, miou, iou_list and
    code_usage."""
    th = confidence_threshold

    def ce(pred, target):
        return cross_entropy_loss(pred, target, ignore_index=IGNORE, weight=ce_weight)

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
            with torch.autocast(device_type, dtype=torch.bfloat16, enabled=half):
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
            filt_1 = confidence_filtered_pseudo(pred_1, torch.argmax(pred_1, dim=1), th, IGNORE)
            filt_2 = confidence_filtered_pseudo(pred_2, torch.argmax(pred_2, dim=1), th, IGNORE)
        cps_loss = (0.5 * ce(pred_1, filt_2) + 0.5 * ce(pred_2, filt_1)
                    + dice_loss(pred_1, filt_2) + dice_loss(pred_2, filt_1))
        sup_loss_1 = 0.5 * ce(pred_sup_1, l_target) + dice_loss(pred_sup_1, l_target)
        sup_loss_2 = 0.5 * ce(pred_sup_2, l_target) + dice_loss(pred_sup_2, l_target)
        commitment = (c_l1 + c_l2 + c_ul1 + c_ul2) * commitment_loss_weight
        prototype = (pl_l1 + pl_l2 + pl_ul1 + pl_ul2) * prototype_loss_weight
        loss = sup_loss_1 + sup_loss_2 + cps_loss_weight * cps_loss + commitment + prototype

        state.opt_1.zero_grad(set_to_none=True)
        state.opt_2.zero_grad(set_to_none=True)
        loss.backward()
        lr = state.schedule(state.step)
        for opt in (state.opt_1, state.opt_2):
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        state.step += 1

        with torch.no_grad():
            step_miou, iou_list = miou(confusion_matrix(pred_sup_1, l_target, num_classes))
            metrics = dict(loss=loss.detach(), cps_loss=cps_loss.detach(),
                           sup_loss_1=sup_loss_1.detach(), sup_loss_2=sup_loss_2.detach(),
                           commitment_loss=commitment.detach(),
                           prototype_loss=prototype.detach(), miou=step_miou,
                           iou_list=iou_list, code_usage=(u_l1 + u_l2 + u_ul1 + u_ul2) / 4.0)
        return state, metrics, pred_sup_1.detach(), pred_ul_1.detach()

    return train_step
