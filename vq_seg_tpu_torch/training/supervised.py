"""The supervised trainer, counterpart of the JAX package's
``training/supervised.py`` (reference train_sup.py /
only_supervised_train.py).

Loss: dice + 0.5 * CE + commitment + prototype, for any ported network
that returns ``(out, commit, usage[, proto])`` or bare logits (``unet``).
CE is applied to the network's output as it comes, so ``vqunet_v2``'s
softmax output is softmaxed again inside CE, as in the JAX package.  The
entropy-percentile ramp ``drop_percent = 100 - drop * (1 - epoch /
num_epochs)`` (``unsup_loss_drop_percent``, default 80) feeds the
networks that take a percent.  ``half=True`` runs the forward under bf16
``torch.autocast``; the losses are f32.  The dropout of ``fcn32s`` (and of
any network whose forward takes ``dropout``) draws its masks from the
driver's generator (``sup_dropout``).
"""
from __future__ import annotations

import dataclasses
import inspect
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from ..data import BaseDataset, Loader, NormalizedDataset, OBIADataset
from ..device import resolve_device
from ..losses import cross_entropy_loss, make_loss
from ..metrics.measurement import confusion_matrix, miou
from ..models.modules.vector_quantizer import ema_updates
from ..models.networks import make_model
from ..parallel.collectives import all_gather, backward, on_mesh
from ..parallel.mesh import Mesh, shard_draw
from ..utils.ckpoints import save_tree, wait_for_saves
from ..utils.logger import Logger
from ..utils.seed import seed_everything
from ..utils.seg_tools import img_to_label
from ..utils.torch_weights import load_encoder_weights, pretrained_encoder, resolve_pretrained
from .cps import IGNORE, _adam, broadcast_parameters_, epoch_summary, model_cfg_with_bn, run_dir
from .schedules import make_lr_schedule


@dataclasses.dataclass
class TrainState:
    """One model, its Adam, the LR schedule and the optimizer steps taken."""

    model: nn.Module
    opt: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def create_state(model_cfg, schedule: Callable[[int], float], *, seed: int = 0,
                 encoder_weights: Optional[str] = None, device="cuda",
                 mesh: Optional[Mesh] = None) -> TrainState:
    """The model drawn from a generator seeded ``seed``, with its Adam.
    ``encoder_weights`` (a tag or a .pth path) loads a pretrained encoder; a
    tag that resolves to no file warns and leaves the drawn weights.  With
    a ``mesh`` every rank draws the same model and then takes the
    parameters and buffers of its data group's first rank."""
    device = resolve_device(device)
    model = make_model(model_cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    if encoder_weights:
        pretrained = resolve_pretrained(encoder_weights, model_cfg["params"].get("encoder_name"))
        if pretrained is not None:
            load_encoder_weights(pretrained_encoder(model), pretrained)
    model = model.to(device).train()
    if mesh is not None:
        broadcast_parameters_(model, mesh)
    return TrainState(model, _adam(model.parameters()), schedule)


def init_phase(state: TrainState, args, *, seed: int = 0, half: bool = False) -> TrainState:
    """The one-time data-dependent init on the first batch, for networks
    whose forward offers it: one train-mode forward (running stats updated
    once) that runs the codebooks' k-means (``init_codebook``) and, where
    the network has one, the prototype table's (``init_protos``), from a
    generator seeded ``seed``.  Networks without codebooks (``unet``) are
    left as they are.  ``args`` are the forward's positional arguments."""
    model = state.model
    offered = inspect.signature(model.forward).parameters
    if "init_codebook" not in offered:
        return state
    kw = {k: True for k in ("init_codebook", "init_protos") if k in offered}
    was_training = model.training
    model.train()
    with torch.no_grad(), ema_updates(), torch.autocast(args[0].device.type,
                                                        dtype=torch.bfloat16, enabled=half):
        model(*args, train=True, generator=torch.Generator().manual_seed(seed), **kw)
    model.train(was_training)
    return state


# forward-signature families across the registry: networks taking (x),
# (x, gt) or (x, gt, percent-or-th).  Names in neither set take gt_extra
# (the prototype-loss family's signature).
PLAIN_NETS = ("unet", "unetoriginal", "vqunet_v1", "vqunet_v2", "vqpatchunet",
              "vqatunet", "vqcanet", "vqcanetv2", "vqcanetv3", "vqcanetv4",
              "drsavqunet", "vqimdbnet", "vqsegheadnet", "deeplabv3",
              "deeplabv3plus", "fcn32s", "VQUnetwithSalientloss", "vqvaev2",
              "vqvaev1")
GT_ONLY_NETS = ("vqptunet", "vqeuptunet", "vqnedptunet", "vqashunet", "vqashunetv2")


def sup_forward_mode(name: str) -> str:
    if name in PLAIN_NETS:
        return "plain"
    if name in GT_ONLY_NETS:
        return "gt"
    return "gt_extra"


def forward_args(forward_mode: str, img, target, extra):
    return {"plain": (img,), "gt": (img, target), "gt_extra": (img, target, extra)}[forward_mode]


def make_sup_train_step(dice_loss, *, num_classes: int, ce_weight=None,
                        forward_mode: str = "gt_extra", half: bool = False,
                        mesh: Optional[Mesh] = None):
    """Build ``train_step(state, img, target, extra, dropout=None) ->
    (state, metrics, pred)``.  ``forward_mode`` is the network's signature:
    "plain" (x), "gt" (x, gt) or "gt_extra" (x, gt, percent-or-th, with
    ``extra``).  ``dropout`` (a callable ``shape -> keep mask``) is handed
    to the forward where it is given.  The forward's output is bare logits
    or a tuple ``(out[, commit[, usage[, proto]]])`` whose missing or None
    terms count 0.  ``metrics`` holds device tensors: loss, sup_loss,
    commitment_loss, prototype_loss, miou, iou_list and code_usage (the
    mean over VQ stages, 0 without VQ).

    With a ``mesh`` each rank passes its shard of the global batch and the
    step runs inside ``data_parallel`` over the data group
    (``parallel.collectives.on_mesh``): losses, BN statistics, code usage and metrics
    are the global batch's, and the gradients are averaged over the group
    before the Adam update.  ``dropout`` must then draw the global batch's
    masks, this rank's rows (``parallel.mesh.shard_draw``)."""
    @on_mesh(mesh)
    def train_step(state: TrainState, img, target, extra, dropout=None):
        model = state.model
        was_training = model.training
        model.train()
        kw = {} if dropout is None else {"dropout": dropout}
        try:
            with ema_updates(), torch.autocast(img.device.type, dtype=torch.bfloat16,
                                               enabled=half):
                out = model(*forward_args(forward_mode, img, target, extra), train=True, **kw)
        finally:
            model.train(was_training)
        zero = img.new_zeros((), dtype=torch.float32)
        pred, commit, usage, proto = out, zero, img.new_zeros((0,)), zero
        if isinstance(out, tuple):  # (out[, commit[, usage[, proto]]])
            pred = out[0]
            if len(out) > 1 and out[1] is not None:
                commit = out[1]
            if len(out) > 2:
                usage = out[2]
            if len(out) > 3 and out[3] is not None:
                proto = out[3]
        pred = pred.float()
        sup = (dice_loss(pred, target)
               + 0.5 * cross_entropy_loss(pred, target, ignore_index=IGNORE, weight=ce_weight))
        loss = sup + commit + proto

        state.opt.zero_grad(set_to_none=True)
        backward(loss, model)
        for group in state.opt.param_groups:
            group["lr"] = state.schedule(state.step)
        state.opt.step()
        state.step += 1

        with torch.no_grad():
            step_miou, iou_list = miou(confusion_matrix(pred, target, num_classes))
            metrics = dict(loss=loss.detach(), sup_loss=sup.detach(),
                           commitment_loss=commit.detach(), prototype_loss=proto.detach(),
                           miou=step_miou, iou_list=iou_list,
                           code_usage=usage.mean() if usage.numel() else zero)
        return state, metrics, pred.detach()

    return train_step


def sup_dropout(cfg, device) -> Callable:
    """The sup driver's dropout draws: a callable ``shape -> keep mask``
    (probability 0.5) from a generator on ``device`` seeded ``train.seed``
    (default 0); every call draws a new mask."""
    generator = torch.Generator(device=device).manual_seed(int(cfg.train.get("seed", 0)))
    return lambda shape: torch.rand(shape, generator=generator, device=device) < 0.5


def train(cfg, max_steps_per_epoch: Optional[int] = None, device="cuda",
          history: Optional[list] = None, mesh: Optional[Mesh] = None) -> TrainState:
    """The supervised driver (train_sup.py flow).  Returns the final state.

    * Data: ``{cfg.train.data_dir}/train`` labelled, seed 0;
      ``cfg.train.dataset`` "normalized" normalises the inputs
      (``norm_mean``/``norm_std``, default 0.5); "obia" trains on
      ``target/`` and the OBIA pseudo-targets of ``obia/``
      (``OBIADataset``; ``tools/obia.py`` writes them).
    * With ``cfg.train.save_dir``: a run directory ``{project_name}_sup_{n}``
      with ``ckpoints/last.ckpt`` = ``{"model_1", "epoch"}`` every epoch,
      and the JSONL logger (or wandb) with ``wandb_logging``.
    * The init phase on the first batch; ``half`` runs the forwards under
      bf16 autocast; ``encoder_weights`` is honoured; a network whose
      forward takes ``dropout`` gets ``sup_dropout``'s masks.
    * ``mesh`` (``parallel.make_mesh``; every rank of it calls ``train``):
      ``cfg.train.batch_size`` is the global batch and each rank decodes
      its shard of every batch; the parameters are broadcast from the data
      group's first rank, the init phase runs on the gathered global batch
      on every rank, the step is ``make_sup_train_step``'s on the mesh and
      the dropout draws the global batch's masks.  Rank (0, 0) alone
      prints, logs and writes the run directory and checkpoints.  A
      ``model`` axis of 2 holds replicas.
    * ``history``: a list that gets one dict per epoch (on every rank).
    """
    device = resolve_device(device)
    ds_kind = cfg.train.get("dataset", "base")
    seed_everything()
    main = mesh is None or mesh.is_main
    num_classes = cfg.num_classes
    batch_size = cfg.train.batch_size
    num_epochs = cfg.train.num_epochs
    half = bool(cfg.train.get("half", False))
    p2l = cfg.pixel_to_label

    root = os.path.join(cfg.train.data_dir, "train")
    if ds_kind == "normalized":
        dataset = NormalizedDataset(root, "labelled", batch_size=batch_size, resize=cfg.resize,
                                    mean=cfg.train.get("norm_mean", 0.5),
                                    std=cfg.train.get("norm_std", 0.5))
    elif ds_kind == "obia":
        dataset = OBIADataset(root, batch_size=batch_size, resize=cfg.resize)
    else:
        dataset = BaseDataset(root, "labelled", batch_size=batch_size, resize=cfg.resize)
    shard = (mesh.data_index, mesh.n_data) if mesh is not None else None
    loader = Loader(dataset, batch_size, shuffle=True, seed=0, device=device, workers=4,
                    shard=shard)
    steps_per_epoch = len(loader)
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)

    schedule = make_lr_schedule(cfg.train, len(loader))
    criterion = cfg.train.criterion
    dice = make_loss(criterion.name, num_classes, ignore_index=IGNORE,
                     weight=criterion.get("weight"))
    forward_mode = sup_forward_mode(cfg.model.name)
    drop = cfg.train.get("unsup_loss_drop_percent", 80.0)
    state = create_state(model_cfg_with_bn(cfg), schedule,
                         encoder_weights=cfg.model.params.get("encoder_weights"), device=device,
                         mesh=mesh)
    train_step = make_sup_train_step(dice, num_classes=num_classes,
                                     ce_weight=criterion.get("weight"),
                                     forward_mode=forward_mode, half=half, mesh=mesh)
    dropout = None
    if "dropout" in inspect.signature(state.model.forward).parameters:
        rows = batch_size // (1 if mesh is None else mesh.n_data)
        dropout = shard_draw(sup_dropout(cfg, device), mesh, rows)
    save_dir = run_dir(cfg, "sup") if main else None
    logger = None
    if save_dir is not None and cfg.wandb_logging:
        logger = Logger(cfg, os.path.basename(save_dir), offline_dir=save_dir)

    initted = False
    for epoch in range(num_epochs):
        drop_percent = float(np.float32(100.0 - drop * (1 - epoch / num_epochs)))
        sums: dict = {}
        t0 = time.time()
        batches = iter(loader)
        for _ in range(steps_per_epoch):
            batch = next(batches)
            img = batch["img"]
            target = img_to_label(batch["target"], p2l)
            if not initted:
                init_img, init_target = img, target
                if mesh is not None:  # the global batch, on every rank
                    init_img = all_gather(img, mesh.data_group)
                    init_target = all_gather(target, mesh.data_group)
                init_phase(state, forward_args(forward_mode, init_img, init_target,
                                               drop_percent), half=half)
                initted = True
            state, metrics, _ = train_step(state, img, target, drop_percent, dropout)
            for k, v in metrics.items():  # on the device, read once per epoch
                sums[k] = sums.get(k, 0) + v
        batches.close()  # ends the loader's thread of a capped epoch
        avg, line = epoch_summary(None, epoch, sums, steps_per_epoch, time.time() - t0)
        if main:
            print(line)
        if logger is not None:
            logger.log_dict.update(avg)
            logger.logging(epoch=epoch)
        if save_dir is not None:
            save_tree({"model_1": state.model, "epoch": epoch},
                      os.path.join(save_dir, "ckpoints", "last.ckpt"))
        if history is not None:
            history.append({"epoch": epoch, "seconds": time.time() - t0,
                            "drop_percent": drop_percent, "step": state.step, **avg})
    wait_for_saves()  # the write in flight
    if logger is not None:
        logger.finish()
    return state
