"""Self-supervised VQ-VAE codebook pretraining, counterpart of the JAX
package's ``training/selfsup.py`` (reference deprecated/self_sup_train.py).

One step: a train-mode forward of the VQ-VAE, ``recon_loss`` = the MSE
between the reconstruction and the input (bilinearly resized to the
reconstruction where they differ), ``loss = recon_loss + commitment``,
one Adam update at ``schedule(step)``.  The codebooks are buffers set by
the k-means init phase; under ``vq_cfg.ema`` the train forward updates
them (``ema_updates``), as the JAX step does.  f32 under
``device.full_f32``, as the JAX driver runs it; ``half`` is not read.

``train`` writes the encoder, codebooks and decoder every epoch with
``save_vqvae`` to ``{save_dir}/selfsup_ckpoints``, the files that
``train.pretrained`` of the ``vqpt`` trainer loads.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import torch

from ..data import FolderDataset, Loader
from ..device import full_f32, resolve_device
from ..models.layers import resize_bilinear
from ..models.modules.vector_quantizer import ema_updates
from ..utils.ckpoints import save_vqvae, wait_for_saves
from ..utils.seed import seed_everything
from ..utils.train_tools import set_lr
from .cps import epoch_summary
from .schedules import make_lr_schedule
from .supervised import TrainState, create_state, init_phase


def make_selfsup_train_step():
    """Build ``train_step(state, img) -> (state, metrics, recon)``.
    ``metrics`` holds device tensors: loss, recon_loss, commitment_loss and
    code_usage (the mean over the VQ stages)."""

    @full_f32()
    def train_step(state: TrainState, img):
        model = state.model
        was_training = model.training
        model.train()
        try:
            with ema_updates():
                recon, commit, usage = model(img, train=True)
        finally:
            model.train(was_training)
        target = img if img.shape[-2:] == recon.shape[-2:] else resize_bilinear(
            img, recon.shape[-2:])
        recon_loss = torch.mean((recon - target) ** 2)
        loss = recon_loss + commit
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        set_lr(state.opt, state.schedule(state.step))
        state.opt.step()
        state.step += 1
        metrics = dict(loss=loss.detach(), recon_loss=recon_loss.detach(),
                       commitment_loss=commit.detach(),
                       code_usage=usage.mean() if usage.numel() else loss.new_zeros(()))
        return state, metrics, recon.detach()

    return train_step


@full_f32()
def train(cfg, max_steps_per_epoch: Optional[int] = None, device="cuda",
          history: Optional[list] = None) -> TrainState:
    """The ``selfsup`` driver.  Returns the final state.

    * Data: the ``*.png`` of ``cfg.train.data_dir`` (``FolderDataset``),
      shuffled from seed 0; ``steps`` = batches, capped by
      ``max_steps_per_epoch``; the LR schedule spans the uncapped count.
    * The model drawn from seed 0 with plain Adam; the init phase (the
      codebooks' k-means, from seed 0) on the first batch.
    * Per epoch the ``[Epoch{e}]`` line and, with ``cfg.train.save_dir``,
      ``save_vqvae`` to ``{save_dir}/selfsup_ckpoints``:
      ``{e}ep_{encoder,codebook,decoder}.ckpt``.
    * ``history``: a list that gets one dict per epoch.
    """
    device = resolve_device(device)
    seed_everything()
    dataset = FolderDataset(cfg.train.data_dir, resize=cfg.resize)
    loader = Loader(dataset, cfg.train.batch_size, shuffle=True, device=device, workers=4)
    steps = len(loader)
    if max_steps_per_epoch:
        steps = min(steps, max_steps_per_epoch)
    state = create_state(cfg.model, make_lr_schedule(cfg.train, len(loader)), device=device)
    step = make_selfsup_train_step()
    ckpt_dir = None
    if cfg.train.get("save_dir"):
        ckpt_dir = os.path.join(cfg.train.save_dir, "selfsup_ckpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
    initted = False
    for epoch in range(cfg.train.num_epochs):
        sums: dict = {}
        t0 = time.time()
        batches = iter(loader)
        for _ in range(steps):
            img = next(batches)["img"]
            if not initted:
                init_phase(state, (img,))
                initted = True
            state, metrics, _ = step(state, img)
            for k, v in metrics.items():  # on the device, read once per epoch
                sums[k] = sums.get(k, 0) + v
        batches.close()  # ends the loader's thread of a capped epoch
        avg, line = epoch_summary(None, epoch, sums, steps, time.time() - t0)
        print(line)
        files = []
        if ckpt_dir is not None:
            save_vqvae(state.model, epoch, ckpt_dir)
            files = [f"{epoch}ep_{part}.ckpt" for part in ("encoder", "codebook", "decoder")]
        if history is not None:
            history.append({"epoch": epoch, "seconds": time.time() - t0, "step": state.step,
                            "ckpt_files": files, **avg})
    wait_for_saves()
    return state
