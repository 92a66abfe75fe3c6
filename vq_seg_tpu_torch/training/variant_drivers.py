"""Variant drivers, counterparts of the JAX package's
``training/variant_drivers.py``: ``train_rept_cps``, ``train_plain_cps``,
``train_obj_cps``, ``train_vqpt_cps``, ``train_easyhard_cps``,
``train_angularv3_cps``, ``train_supcon_cps``, ``train_semiweed``,
``train_unimatch`` and ``train_salient_cps``, with ``_Run`` (the run
directory, loaders, epochs and checkpoints they share), ``plain_step``
(the step and optimizers of ``plaincps`` and ``objcps``) and ``vqpt_step``
(the step of ``vqpt`` and ``easyhard``).

Like the JAX drivers they have no resume, no preemption guard, no bf16 and
no decoder re-init: ``train.half`` and ``train.init_weights`` are not read,
although the shipped configs say ``"half": true`` (the JAX drivers of these
modes open no bf16 context).  They run in f32 under ``device.full_f32``:
no TF32 in cuDNN or cuBLAS.
"""
from __future__ import annotations

import os
import time
from itertools import cycle
from typing import Callable, Optional

import numpy as np
import torch

from ..data import Loader, SalientDataset
from ..data.augmentations import make_cutout_mask
from ..device import full_f32, resolve_device
from ..losses import make_loss
from ..utils.ckpoints import (fetch_ckpt_tree, load_vqvae_pretrained, save_ckpoints,
                              save_tree, wait_for_saves)
from ..utils.logger import Logger
from ..utils.seed import seed_everything
from ..utils.seg_tools import img_to_label
from ..utils.train_tools import freeze_encoder_adam, multi_lr_adam
from .cps import (IGNORE, CPSTrainState, cps_init_phase, create_cps_state, epoch_summary,
                  evaluate, make_test_loader, model_cfg_with_bn, run_dir, semi_loaders)
from .schedules import make_lr_schedule
from .supervised import TrainState, create_state, init_phase
from .variants import (make_angularv3_cps_train_step, make_easyhard_cps_train_step,
                       make_objloss_cps_train_step, make_plain_cps_train_step,
                       make_rept_cps_train_step, make_salient_cps_train_step,
                       make_semiweed_train_step, make_supcon_cps_train_step,
                       make_unimatch_train_step, make_vqpt_cps_train_step)


class _Run:
    """A driver's run directory (``{project_name}_{tag}_{n}`` with
    ``log_txt`` and ``ckpoints/``), its logger (JSONL or wandb with
    ``wandb_logging``), loaders, test loader and the per-epoch bookkeeping
    shared by the dual-model drivers.  ``evaluate=False`` runs no test
    split whatever ``test_every`` says; ``loaders`` replaces the labelled
    and unlabelled loaders of ``semi_loaders``."""

    def __init__(self, cfg, tag: str, device, max_steps_per_epoch: Optional[int],
                 evaluate: bool = True, loaders=None):
        self.cfg, self.tag, self.device = cfg, tag, device
        seed_everything()
        save_dir = run_dir(cfg, tag)
        self.ckpoints_dir = self.log_txt = self.logger = None
        if save_dir is not None:
            self.ckpoints_dir = os.path.join(save_dir, "ckpoints")
            self.log_txt = os.path.join(save_dir, "log_txt")
            open(self.log_txt, "w").close()
            if cfg.wandb_logging:
                self.logger = Logger(cfg, os.path.basename(save_dir), offline_dir=save_dir)
        self.sup_loader, self.unsup_loader = loaders or semi_loaders(cfg, device)
        self.steps = len(self.unsup_loader)
        if max_steps_per_epoch:
            self.steps = min(self.steps, max_steps_per_epoch)
        # the LR schedule spans the uncapped epoch
        self.schedule = make_lr_schedule(cfg.train, len(self.unsup_loader))
        self.tests = make_test_loader(cfg, device) if evaluate else None

    def train(self, state, step: Callable, init: Callable, history: Optional[list],
              epoch_args: Callable[[int], dict] = lambda e: {},
              batch_args: Callable[[dict, dict], dict] = lambda sup, unsup: {}):
        """The epochs: ``zip(cycle(sup), unsup)``, ``init(state, l_img,
        l_target)`` before the first step, ``step(state, l_img, l_target,
        ul_img, **epoch_args(epoch), **batch_args(sup_batch,
        unsup_batch))``, then the epoch's line, evaluation of
        model 1 every ``test_every`` epochs and ``{e}ep.ckpt`` every 10
        epochs and ``last.ckpt`` every epoch, the full contract.  A
        one-model state (a supervised ``TrainState``) is evaluated and
        written as ``last.ckpt`` = ``{model_1, epoch, optimizer_1}`` every
        epoch."""
        cfg, p2l = self.cfg, self.cfg.pixel_to_label
        initted = False
        for epoch in range(cfg.train.num_epochs):
            extra = epoch_args(epoch)
            batches = zip(cycle(iter(self.sup_loader)), iter(self.unsup_loader))
            sums: dict = {}
            t0 = time.time()
            for _ in range(self.steps):
                sup_batch, unsup_batch = next(batches)
                l_img = sup_batch["img"]
                l_target = img_to_label(sup_batch["target"], p2l)
                ul_img = unsup_batch["img"]
                if not initted:
                    init(state, l_img, l_target)
                    initted = True
                state, metrics = step(state, l_img, l_target, ul_img, **extra,
                                      **batch_args(sup_batch, unsup_batch))
                for k, v in metrics.items():  # on the device, read once per epoch
                    sums[k] = sums.get(k, 0) + v
            del batches  # ends the loaders' threads of a capped epoch
            self._end_epoch(state, epoch, sums, t0, extra, history)
        wait_for_saves()  # the write in flight
        if self.logger is not None:
            self.logger.finish()
        return state

    def _end_epoch(self, state, epoch: int, sums: dict, t0: float, extra: dict,
                   history: Optional[list]):
        cfg = self.cfg
        avg, line = epoch_summary(self.tag, epoch, sums, self.steps, time.time() - t0)
        print(line)
        record = {"epoch": epoch, "seconds": time.time() - t0, **extra, "step": state.step,
                  "test_miou": None, "ckpt_files": [], **avg}
        if self.log_txt is not None:
            with open(self.log_txt, "a") as f:
                f.write(line + "\n")
        if self.logger is not None:
            self.logger.log_dict.update(avg)
            self.logger.logging(epoch=epoch)
        single = isinstance(state, TrainState)
        if self.tests is not None and epoch % cfg.train.test_every == 0:
            record["test_miou"] = evaluate(state.model if single else state.model_1, self.tests,
                                           cfg.pixel_to_label, cfg.num_classes,
                                           device=self.device)
            print(f"test miou : {record['test_miou']}")
        if self.ckpoints_dir is not None and single:
            save_tree({"model_1": state.model, "epoch": epoch, "optimizer_1": state.opt},
                      os.path.join(self.ckpoints_dir, "last.ckpt"))
            record["ckpt_files"] = ["last.ckpt"]
        elif self.ckpoints_dir is not None:
            # one host copy shared by the snapshot and last.ckpt
            host_ck = fetch_ckpt_tree(state.model_1, state.model_2, epoch, self.steps - 1,
                                      state.opt_1, state.opt_2)
            names = ([f"{epoch}ep.ckpt"] if epoch % 10 == 0 else []) + ["last.ckpt"]
            for name in names:
                save_ckpoints(None, None, epoch, self.steps - 1, None, None,
                              os.path.join(self.ckpoints_dir, name), prefetched=host_ck)
            record["ckpt_files"] = names
        if history is not None:
            history.append(record)


@full_f32()
def train_rept_cps(cfg, max_steps_per_epoch: Optional[int] = None, device="cuda",
                   history: Optional[list] = None):
    """The ``reptcps`` driver (reference
    train_with_test_pt_pseudo_entropy_reg.py:124-210).  Returns the final
    ``CPSTrainState``.

    * Run directory ``{project_name}_reptcps_{n}`` with ``log_txt`` and
      ``ckpoints/``; the JSONL logger (or wandb) with ``wandb_logging``.
    * Loaders as the flagship's driver; ``steps`` = batches of the
      unlabelled loader, capped by ``max_steps_per_epoch``; the LR schedule
      spans the uncapped count.
    * Per epoch, ``drop_percent = 100 - unsup_loss_drop_percent * (1 -
      epoch / num_epochs)`` (default 20), rounded to f32 as JAX's traced
      scalar is, feeds the networks' entropy filter and the pseudo-label
      regularizer.
    * The init phase on the first labelled batch at percent 100, the two
      models drawing from generators seeded 0 and 1.
    * ``evaluate`` of model 1 every ``test_every`` epochs; ``{e}ep.ckpt``
      every 10 epochs and ``last.ckpt`` every epoch, the full contract.
    * ``encoder_weights`` is honoured, as the flagship's driver does.
    * ``history``: a list that gets one dict per epoch (averages, seconds,
      test mIoU, checkpoint files).
    """
    device = resolve_device(device)
    run = _Run(cfg, "reptcps", device, max_steps_per_epoch)
    criterion = make_loss(cfg.train.criterion.name, cfg.num_classes, ignore_index=IGNORE,
                          weight=cfg.train.criterion.get("weight"))
    state = create_cps_state(model_cfg_with_bn(cfg), run.schedule,
                             encoder_weights=cfg.model.params.get("encoder_weights"),
                             device=device)
    step = make_rept_cps_train_step(
        criterion, num_classes=cfg.num_classes,
        cps_loss_weight=cfg.train.get("cps_loss_weight", 1.0),
        commitment_loss_weight=cfg.train.get("total_commitment_loss_weight", 1.0),
        prototype_loss_weight=cfg.train.get("total_prototype_loss_weight", 0.01))
    num_epochs = cfg.train.num_epochs
    drop_base = float(cfg.train.get("unsup_loss_drop_percent", 20))

    def drop_percent(epoch):
        return {"drop_percent": float(np.float32(100.0 - drop_base * (1 - epoch / num_epochs)))}

    def init(state, l_img, l_target):
        cps_init_phase(state, l_img, l_target, 100.0)

    return run.train(state, step, init, history, drop_percent)


def plain_init_phase(state: CPSTrainState, l_img: torch.Tensor, l_target: torch.Tensor):
    """The plain-forward networks' init phase on the first labeled batch:
    ``supervised.init_phase`` of model 1 from seed 0 and of model 2 from
    seed 1, as the JAX drivers of ``plaincps`` and ``objcps`` do."""
    for seed, model in enumerate((state.model_1, state.model_2)):
        init_phase(TrainState(model, None, state.schedule), (l_img,), seed=seed)
    return state


def plain_step(cfg, state: CPSTrainState, mode: str) -> Callable:
    """The step of ``mode`` (``plaincps`` or ``objcps``) as its driver
    builds it from ``cfg``, with ``state``'s optimizers set as the driver
    sets them: for ``plaincps`` Adam with the encoder at ``lr /
    decoder_lr_times``, for ``objcps`` the plain Adam of
    ``create_cps_state``."""
    tc = cfg.train
    if mode == "plaincps":
        times = tc.get("decoder_lr_times", 1)
        state.opt_1 = multi_lr_adam(state.model_1, times)
        state.opt_2 = multi_lr_adam(state.model_2, times)
        return make_plain_cps_train_step(
            num_classes=cfg.num_classes, cps_loss_weight=tc.get("cps_loss_weight", 1.0),
            ce_weight=tc.criterion.get("weight"),
            usage_loss_weight=tc.get("code_usage_loss_weight", 0.0),
            depth=cfg.model.params.get("depth", 5))
    if mode != "objcps":
        raise ValueError(f"plain_step: mode {mode!r} is not plaincps or objcps")
    criterion = make_loss(tc.criterion.name, cfg.num_classes, ignore_index=IGNORE,
                          weight=tc.criterion.get("weight"))
    return make_objloss_cps_train_step(
        criterion, make_loss(tc.criterion.name, 1), num_classes=cfg.num_classes,
        batch_size=tc.batch_size, cps_loss_weight=tc.get("cps_loss_weight", 1.0),
        commitment_loss_weight=tc.get("total_commitment_loss_weight", 1.0),
        obj_loss_weight=tc.get("obj_loss_weight", 1.0))


@full_f32()
def train_plain_cps(cfg, max_steps_per_epoch: Optional[int] = None, device="cuda",
                    history: Optional[list] = None):
    """The ``plaincps`` driver (reference deprecated/train_CPS.py), for any
    plain-forward network (``vqunet_v2`` and the attention networks).
    Returns the final ``CPSTrainState``.

    * Run directory ``{project_name}_plaincps_{n}``; loaders, ``steps`` and
      the LR schedule as ``train_rept_cps``.
    * Adam, with the encoder at ``lr / decoder_lr_times`` where the config
      sets it (``vqatunet.json``: 10).
    * The criterion is CE with ignore index 255 and ``criterion.weight``,
      whatever ``criterion.name`` says; ``code_usage_loss_weight`` adds the
      gradient-free usage term.
    * ``plain_init_phase`` on the first labelled batch.
    * ``evaluate`` of model 1 every ``test_every`` epochs (only when set);
      ``{e}ep.ckpt`` every 10 epochs and ``last.ckpt`` every epoch.
    * ``encoder_weights`` is honoured (``utils/torch_weights.py``).
    * f32 throughout: the JAX driver has no bf16 context, so ``half`` is
      not read.
    * ``history``: a list that gets one dict per epoch.
    """
    device = resolve_device(device)
    run = _Run(cfg, "plaincps", device, max_steps_per_epoch)
    state = create_cps_state(model_cfg_with_bn(cfg), run.schedule,
                             encoder_weights=cfg.model.params.get("encoder_weights"),
                             device=device)
    step = plain_step(cfg, state, "plaincps")
    return run.train(state, step, plain_init_phase, history)


@full_f32()
def train_obj_cps(cfg, max_steps_per_epoch: Optional[int] = None, device="cuda",
                  history: Optional[list] = None):
    """The ``objcps`` driver (reference
    deprecated/train_with_test_object_loss.py): plain CPS with the
    configured criterion plus the binary object loss on the non-background
    softmax mass, weighted by ``obj_loss_weight``, and the commitment
    losses weighted by ``total_commitment_loss_weight``.  Plain Adam (no
    ``decoder_lr_times``); otherwise as ``train_plain_cps``, with the run
    directory ``{project_name}_objcps_{n}``.  Returns the final
    ``CPSTrainState``."""
    device = resolve_device(device)
    run = _Run(cfg, "objcps", device, max_steps_per_epoch)
    state = create_cps_state(model_cfg_with_bn(cfg), run.schedule,
                             encoder_weights=cfg.model.params.get("encoder_weights"),
                             device=device)
    step = plain_step(cfg, state, "objcps")
    return run.train(state, step, plain_init_phase, history)


def vqpt_init_phase(state: CPSTrainState, l_img: torch.Tensor, l_target: torch.Tensor,
                    init_codebook: bool = True, extra: tuple = (), init_protos: bool = True):
    """The ``(x, gt)`` networks' init phase on the first labeled batch, as
    the JAX drivers of ``vqpt``, ``easyhard``, ``angularv3`` and
    ``supconcps`` run it: one train-mode forward with the labels (and the
    ``extra`` arguments) of each model (running stats updated once), model
    1 from a generator seeded 0 and model 2 from 1, that sets the codebooks
    to the k-means of the encoder features (unless ``init_codebook`` is
    false: pretrained codebooks) and, with ``init_protos``, the prototype or
    embedding table by its ``pt_init``."""
    kw = {"init_protos": True} if init_protos else {}
    for seed, model in enumerate((state.model_1, state.model_2)):
        was_training = model.training
        model.train()
        with torch.no_grad():
            model(l_img, l_target, *extra, train=True, init_codebook=init_codebook,
                  generator=torch.Generator().manual_seed(seed), **kw)
        model.train(was_training)
    return state


def vqpt_step(cfg, mode: str = "vqpt") -> Callable:
    """The step of ``mode`` (``vqpt``, ``easyhard``, ``angularv3`` or
    ``supconcps``) as its driver builds it from ``cfg``: the configured
    criterion (ignore index 255, its weight), ``cps_loss_weight`` and
    ``total_commitment_loss_weight``, and the mode's own weight: the
    prototype weight ``total_prototype_loss_weight`` (for ``vqpt`` falling
    back to ``total_angular_loss_weight``, the angular-head configs' name,
    then 0.01; for the others to 0.01) or ``supconcps``'s
    ``total_sup_con_loss_weight`` (default 1); ``angularv3`` also takes the
    criterion's weight for its CE."""
    tc = cfg.train
    criterion = make_loss(tc.criterion.name, cfg.num_classes, ignore_index=IGNORE,
                          weight=tc.criterion.get("weight"))
    kw = dict(num_classes=cfg.num_classes, cps_loss_weight=tc.get("cps_loss_weight", 1.0),
              commitment_loss_weight=tc.get("total_commitment_loss_weight", 1.0))
    proto = tc.get("total_prototype_loss_weight", 0.01)
    if mode == "vqpt":
        return make_vqpt_cps_train_step(
            criterion, prototype_loss_weight=tc.get(
                "total_prototype_loss_weight", tc.get("total_angular_loss_weight", 0.01)), **kw)
    if mode == "easyhard":
        return make_easyhard_cps_train_step(criterion, prototype_loss_weight=proto, **kw)
    if mode == "angularv3":
        return make_angularv3_cps_train_step(criterion, prototype_loss_weight=proto,
                                             ce_weight=tc.criterion.get("weight"), **kw)
    if mode == "supconcps":
        return make_supcon_cps_train_step(
            criterion, sup_con_loss_weight=tc.get("total_sup_con_loss_weight", 1.0), **kw)
    raise ValueError(f"vqpt_step: mode {mode!r} is not vqpt, easyhard, angularv3 or supconcps")


@full_f32()
def train_vqpt_cps(cfg, max_steps_per_epoch: Optional[int] = None, device="cuda",
                   history: Optional[list] = None):
    """The ``vqpt`` driver (reference deprecated/train_vq_pt_unet.py and
    train_only_decoder.py), for the ``(x, gt)`` networks.  Returns the final
    ``CPSTrainState``.

    * Run directory ``{project_name}_vqpt_{n}``; loaders, ``steps`` and the
      LR schedule as ``train_rept_cps``; plain Adam.
    * The step of ``vqpt_step``; ``vqpt_init_phase`` on the first labelled
      batch.
    * ``train.pretrained.{encoder,codebook}``: files of ``save_vqvae``,
      loaded into both models (``load_vqvae_pretrained``); the encoder is
      then frozen (``freeze_encoder_adam``: its parameters stay bitwise,
      its BN statistics move) and the init phase sets the prototype tables
      only.  Without it ``encoder_weights`` is honoured.
    * ``evaluate`` of model 1 every ``test_every`` epochs (only when set);
      ``{e}ep.ckpt`` every 10 epochs and ``last.ckpt`` every epoch.
    * f32 throughout under ``device.full_f32`` (no TF32 in cuDNN or
      cuBLAS): the JAX driver opens no bf16 context, so ``half`` is not
      read, although the shipped configs say ``"half": true``.
    * ``history``: a list that gets one dict per epoch.
    """
    device = resolve_device(device)
    run = _Run(cfg, "vqpt", device, max_steps_per_epoch)
    pretrained = cfg.train.get("pretrained")
    state = create_cps_state(
        model_cfg_with_bn(cfg), run.schedule, device=device,
        encoder_weights=None if pretrained else cfg.model.params.get("encoder_weights"))
    if pretrained:
        for model in (state.model_1, state.model_2):
            load_vqvae_pretrained(model, pretrained["encoder"], pretrained["codebook"])
        state.opt_1 = freeze_encoder_adam(state.model_1)
        state.opt_2 = freeze_encoder_adam(state.model_2)

    def init(state, l_img, l_target):
        vqpt_init_phase(state, l_img, l_target, init_codebook=not pretrained)

    return run.train(state, vqpt_step(cfg), init, history)


def easyhard_draws(cfg, device) -> Callable:
    """The ``easyhard`` driver's per-step draws, ``draw((H, W)) -> (mask,
    case)``: the CutMix mask at ``train.cutmix_ratio`` (default 0.5) from a
    CPU generator, put on ``device``, and the dihedral case as the JAX
    driver draws it, ``numpy.random.default_rng(seed).integers(0, 10)``
    (1 and 2 flip, anything else is the identity); both seeded
    ``train.seed`` (default 0)."""
    seed = int(cfg.train.get("seed", 0))
    generator = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    ratio = float(cfg.train.get("cutmix_ratio", 0.5))

    def draw(hw):
        mask = make_cutout_mask(generator, tuple(hw), ratio, device=device)
        case = int(rng.integers(0, 10))
        return mask, case if case in (1, 2) else 0

    return draw


@full_f32()
def train_easyhard_cps(cfg, max_steps_per_epoch: Optional[int] = None, device="cuda",
                       history: Optional[list] = None):
    """The ``easyhard`` driver (reference
    deprecated/train_vqpt_easyhard_aug.py), for the ``(x, gt)`` networks.
    Returns the final ``CPSTrainState``.

    * Run directory ``{project_name}_easyhard_{n}``; loaders, ``steps``,
      the LR schedule (``poly`` in the shipped config) and plain Adam as
      ``train_vqpt_cps``; ``encoder_weights`` is honoured.
    * ``vqpt_init_phase`` on the first labelled batch, then per step the
      draws of ``easyhard_draws`` and the step of ``vqpt_step(cfg,
      "easyhard")``; the epoch's keys are ``sup_loss`` and ``cps_loss``.
    * No evaluation, as the JAX driver; ``{e}ep.ckpt`` every 10 epochs and
      ``last.ckpt`` every epoch.
    * f32 throughout under ``device.full_f32``; ``half`` is not read.
    * ``history``: a list that gets one dict per epoch.
    """
    device = resolve_device(device)
    run = _Run(cfg, "easyhard", device, max_steps_per_epoch, evaluate=False)
    state = create_cps_state(model_cfg_with_bn(cfg), run.schedule,
                             encoder_weights=cfg.model.params.get("encoder_weights"),
                             device=device)
    step = vqpt_step(cfg, "easyhard")
    draw = easyhard_draws(cfg, device)

    def easyhard_step(state, l_img, l_target, ul_img):
        return step(state, l_img, l_target, ul_img, *draw(ul_img.shape[-2:]))

    return run.train(state, easyhard_step, vqpt_init_phase, history)


def angularv3_threshold(epoch: int, num_epochs: int) -> float:
    """The ``angularv3`` driver's threshold of ``epoch``: ``(epoch + 1) /
    num_epochs`` before epoch 70, then 0.7, rounded to f32 as JAX's traced
    scalar is."""
    return float(np.float32((epoch + 1) / num_epochs if epoch < 70 else 0.7))


@full_f32()
def train_angularv3_cps(cfg, max_steps_per_epoch: Optional[int] = None, device="cuda",
                        history: Optional[list] = None):
    """The ``angularv3`` driver (reference deprecated/train_angularv3.py)
    for ``vqreptunetangularv3``.  Returns the final ``CPSTrainState``.

    * Run directory ``{project_name}_angularv3_{n}``; loaders, ``steps``,
      the LR schedule and plain Adam as ``train_rept_cps``;
      ``encoder_weights`` is honoured.
    * The init phase on the first labelled batch (the ``"labeled"`` split
      at threshold 0): codebooks and embedding tables by k-means, model 1
      from seed 0 and model 2 from 1.
    * Per epoch the threshold of ``angularv3_threshold``; the step of
      ``vqpt_step(cfg, "angularv3")``.
    * ``evaluate`` of model 1 every ``test_every`` epochs; ``{e}ep.ckpt``
      every 10 epochs and ``last.ckpt`` every epoch.
    * f32 under ``device.full_f32``; ``half`` is not read.
    * ``history``: a list that gets one dict per epoch.
    """
    device = resolve_device(device)
    run = _Run(cfg, "angularv3", device, max_steps_per_epoch)
    state = create_cps_state(model_cfg_with_bn(cfg), run.schedule,
                             encoder_weights=cfg.model.params.get("encoder_weights"),
                             device=device)
    step = vqpt_step(cfg, "angularv3")
    num_epochs = cfg.train.num_epochs

    def init(state, l_img, l_target):
        vqpt_init_phase(state, l_img, l_target, extra=("labeled", 0.0))

    return run.train(state, step, init, history,
                     lambda epoch: {"th": angularv3_threshold(epoch, num_epochs)})


@full_f32()
def train_supcon_cps(cfg, max_steps_per_epoch: Optional[int] = None, device="cuda",
                     history: Optional[list] = None):
    """The ``supconcps`` driver (reference deprecated/train_supcon_unet.py)
    for ``supconvqunet``.  Returns the final ``CPSTrainState``.

    * Run directory ``{project_name}_supconcps_{n}``; loaders, ``steps``,
      the LR schedule and plain Adam as ``train_rept_cps``;
      ``encoder_weights`` is honoured.
    * The init phase on the first labelled batch (the ``"label"`` split):
      codebooks by k-means, model 1 from seed 0 and model 2 from 1.
    * The step of ``vqpt_step(cfg, "supconcps")``.
    * ``evaluate`` of model 1 every ``test_every`` epochs; ``{e}ep.ckpt``
      every 10 epochs and ``last.ckpt`` every epoch.
    * f32 under ``device.full_f32``; ``half`` is not read.
    * ``history``: a list that gets one dict per epoch.
    """
    device = resolve_device(device)
    run = _Run(cfg, "supconcps", device, max_steps_per_epoch)
    state = create_cps_state(model_cfg_with_bn(cfg), run.schedule,
                             encoder_weights=cfg.model.params.get("encoder_weights"),
                             device=device)
    step = vqpt_step(cfg, "supconcps")

    def init(state, l_img, l_target):
        vqpt_init_phase(state, l_img, l_target, extra=("label",), init_protos=False)

    return run.train(state, step, init, history)


def semiweed_draws(cfg, device) -> Callable:
    """The ``semiweed`` driver's per-step draws, ``draw() -> (case1, case2,
    dropout)``: the two dihedral cases as the JAX driver draws them,
    ``numpy.random.default_rng(seed).integers(0, 10)`` twice (1 and 2 flip,
    anything else is the identity), and for each of the step's three passes
    a callable that draws the ASPP's keep mask (probability 0.5) from a
    generator on ``device``; both seeded ``train.seed`` (default 0)."""
    seed = int(cfg.train.get("seed", 0))
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)

    def keep(shape):
        return torch.rand(shape, generator=generator, device=device) < 0.5

    def draw():
        cases = [int(rng.integers(0, 10)) for _ in range(2)]
        case1, case2 = (c if c in (1, 2) else 0 for c in cases)
        return case1, case2, (keep, keep, keep)

    return draw


def semiweed_state(cfg, schedule, device) -> TrainState:
    """The ``semiweed`` driver's model (drawn from seed 0) and its Adam;
    ``encoder_weights`` is honoured."""
    return create_state(cfg.model, schedule, encoder_weights=cfg.model.params.get(
        "encoder_weights"), device=device)


@full_f32()
def train_semiweed(cfg, max_steps_per_epoch: Optional[int] = None, device="cuda",
                   history: Optional[list] = None):
    """The ``semiweed`` driver (reference deprecated/semiweednet_train.py)
    for ``semiweednet``: one model.  Returns the final ``TrainState``.

    * Run directory ``{project_name}_semiweed_{n}``; loaders, ``steps``
      and the LR schedule as ``train_rept_cps``; plain Adam; no init phase.
    * Per step the draws of ``semiweed_draws`` and the step of
      ``make_semiweed_train_step`` with the config's criterion,
      ``overlap_size`` (default 240), ``ce_loss_weight`` and
      ``dc_loss_weight``.
    * ``evaluate`` every ``test_every`` epochs; ``last.ckpt`` = ``{model_1,
      epoch, optimizer_1}`` every epoch, which the test CLI's sweep reads.
    * f32 under ``device.full_f32``; ``half`` is not read.
    * ``history``: a list that gets one dict per epoch.
    """
    device = resolve_device(device)
    run = _Run(cfg, "semiweed", device, max_steps_per_epoch)
    tc = cfg.train
    criterion = make_loss(tc.criterion.name, cfg.num_classes, ignore_index=IGNORE,
                          weight=tc.criterion.get("weight"))
    state = semiweed_state(cfg, run.schedule, device)
    step = make_semiweed_train_step(
        criterion, num_classes=cfg.num_classes, overlap_size=tc.get("overlap_size", 240),
        ce_loss_weight=tc.get("ce_loss_weight", 1.0), dc_loss_weight=tc.get("dc_loss_weight", 1.0))
    draw = semiweed_draws(cfg, device)

    def semiweed_step(state, l_img, l_target, ul_img):
        return step(state, l_img, l_target, ul_img, *draw())

    return run.train(state, semiweed_step, lambda *_: None, history)


def unimatch_draws(cfg, device) -> Callable:
    """The ``unimatch`` driver's per-step draws, ``draw((H, W)) -> (mask_1,
    mask_2, dropout, fp_dropout)``: two CutMix masks at
    ``train.cutmix_ratio`` (default 0.5) from a CPU generator, put on
    ``device``, and the dropout of the step's passes from a generator on
    ``device``, both seeded ``train.seed`` (default 0).  ``dropout`` draws
    one keep mask (probability 0.5) per shape and step and hands the same
    one out again for that shape, as the JAX step's one dropout key does;
    ``fp_dropout`` draws a new one per call."""
    seed = int(cfg.train.get("seed", 0))
    generator = torch.Generator().manual_seed(seed)
    dev_generator = torch.Generator(device=device).manual_seed(seed)
    ratio = float(cfg.train.get("cutmix_ratio", 0.5))

    def keep(shape):
        return torch.rand(shape, generator=dev_generator, device=device) < 0.5

    def draw(hw):
        masks = [make_cutout_mask(generator, tuple(hw), ratio, device=device) for _ in range(2)]
        by_shape: dict = {}

        def dropout(shape):
            if shape not in by_shape:
                by_shape[shape] = keep(shape)
            return by_shape[shape]

        return masks[0], masks[1], dropout, keep

    return draw


def unimatch_state(cfg, schedule, device) -> TrainState:
    """The ``unimatch`` driver's model (drawn from seed 0) and its Adam;
    ``encoder_weights`` is honoured."""
    return create_state(cfg.model, schedule, encoder_weights=cfg.model.params.get(
        "encoder_weights"), device=device)


@full_f32()
def train_unimatch(cfg, max_steps_per_epoch: Optional[int] = None, device="cuda",
                   history: Optional[list] = None):
    """The ``unimatch`` driver (reference deprecated/train_UniMatch.py) for
    the ``unimatch`` network: one model.  Returns the final ``TrainState``.

    * Run directory ``{project_name}_unimatch_{n}``; loaders, ``steps``
      and the LR schedule as ``train_rept_cps``; plain Adam; no init phase.
    * Per step the draws of ``unimatch_draws`` and the step of
      ``make_unimatch_train_step`` at ``train.confidence_threshold``
      (default 0.95) with the criterion's weight.
    * ``evaluate`` every ``test_every`` epochs; ``last.ckpt`` = ``{model_1,
      epoch, optimizer_1}`` every epoch.
    * f32 under ``device.full_f32``; ``half`` is not read.
    * ``history``: a list that gets one dict per epoch.
    """
    device = resolve_device(device)
    run = _Run(cfg, "unimatch", device, max_steps_per_epoch)
    state = unimatch_state(cfg, run.schedule, device)
    step = make_unimatch_train_step(
        num_classes=cfg.num_classes,
        confidence_threshold=cfg.train.get("confidence_threshold", 0.95),
        ce_weight=cfg.train.criterion.get("weight"))
    draw = unimatch_draws(cfg, device)

    def unimatch_step(state, l_img, l_target, ul_img):
        return step(state, l_img, l_target, ul_img, *draw(ul_img.shape[-2:]))

    return run.train(state, unimatch_step, lambda *_: None, history)


def salient_loaders(cfg, device):
    """The labelled and unlabelled ``SalientDataset`` loaders over
    ``{data_dir}/train`` with the maps of ``train.salient_dir``, seeds 0
    and 1, not padded to a batch multiple (the JAX driver's)."""
    root = os.path.join(cfg.train.data_dir, "train")
    bs = cfg.train.batch_size
    return tuple(Loader(SalientDataset(root, cfg.train.salient_dir, split, resize=cfg.resize),
                        bs, shuffle=True, seed=seed, device=device, workers=4)
                 for seed, split in enumerate(("labelled", "unlabelled")))


def salient_step(cfg) -> Callable:
    """The ``salientcps`` step as its driver builds it from ``cfg``:
    ``cps_loss_weight``, ``total_commitment_loss_weight``,
    ``auxiliary_loss_weight`` (each default 1) and the criterion's
    weight."""
    tc = cfg.train
    return make_salient_cps_train_step(
        num_classes=cfg.num_classes, cps_loss_weight=tc.get("cps_loss_weight", 1.0),
        commitment_loss_weight=tc.get("total_commitment_loss_weight", 1.0),
        auxiliary_loss_weight=tc.get("auxiliary_loss_weight", 1.0),
        ce_weight=tc.criterion.get("weight"))


@full_f32()
def train_salient_cps(cfg, max_steps_per_epoch: Optional[int] = None, device="cuda",
                      history: Optional[list] = None):
    """The ``salientcps`` driver (reference deprecated/train_salient_loss.py)
    for two ``VQUnetwithSalientloss`` models.  Returns the final
    ``CPSTrainState``.

    * Run directory ``{project_name}_salientcps_{n}``; the loaders of
      ``salient_loaders`` (``train.salient_dir`` holds a gray PNG per
      input, e.g. from ``tools/saliency.py``); ``steps`` and the LR schedule
      as ``train_rept_cps``; plain Adam; ``encoder_weights`` is honoured.
    * ``plain_init_phase`` on the first labelled batch (the codebooks'
      k-means, model 1 from seed 0 and model 2 from 1), then the step of
      ``salient_step`` with each batch's maps.
    * No evaluation, as the JAX driver; ``{e}ep.ckpt`` every 10 epochs and
      ``last.ckpt`` every epoch, the full contract.
    * f32 under ``device.full_f32``; ``half`` is not read.
    * ``history``: a list that gets one dict per epoch.
    """
    device = resolve_device(device)
    run = _Run(cfg, "salientcps", device, max_steps_per_epoch, evaluate=False,
               loaders=salient_loaders(cfg, device))
    state = create_cps_state(model_cfg_with_bn(cfg), run.schedule,
                             encoder_weights=cfg.model.params.get("encoder_weights"),
                             device=device)

    def maps(sup_batch, unsup_batch):
        return {"l_sal": sup_batch["salient_map"], "ul_sal": unsup_batch["salient_map"]}

    step = salient_step(cfg)

    def salient(state, l_img, l_target, ul_img, l_sal, ul_sal):
        return step(state, l_img, l_target, l_sal, ul_img, ul_sal)

    return run.train(state, salient, plain_init_phase, history, batch_args=maps)
