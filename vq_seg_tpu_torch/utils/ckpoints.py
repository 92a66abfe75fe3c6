"""Checkpointing (reference utils/ckpoints.py:7-33), counterpart of the JAX
package's ``utils/ckpoints.py``, on ``torch.save``.

The checkpoint contract ``{model_1, model_2, epoch, batch_idx,
optimizer_1, optimizer_2}`` is one file per ``.ckpt``: models are
``state_dict()``s, optimizers ``Adam.state_dict()``s, epoch and batch_idx
ints.  ``serving.Predictor.from_checkpoint`` reads ``model_1`` of these
files.

  * ``fetch_ckpt_tree`` copies the contract to the host once (on the card:
    non-blocking copies, then one synchronize), so that a ``{N}ep.ckpt``
    snapshot and ``last.ckpt`` written in the same epoch share it;
  * ``save_ckpoints`` writes it, by default in one background thread with
    at most one write in flight (each save first waits for the previous
    one; ``wait_for_saves`` waits for the last).  A file is written under a
    temporary name and renamed, so a reader never sees half of it.
    ``include_optimizers=False`` writes a light snapshot (models, epoch,
    batch_idx); ``save_tree`` writes any other tree the same way;
  * ``load_ckpoints(path, istrain)`` returns the train-resume tuple, and
    raises on a light snapshot, or ``model_1`` for evaluation;
  * ``latest_ckpt`` finds the newest run's ``last.ckpt`` for
    ``resume: "auto"``; ``save_tar`` gzips and removes a run directory;
  * ``save_vqvae`` writes a network's encoder, codebooks and decoder to
    three files (a VQ-VAE's every epoch of the ``selfsup`` trainer), and
    ``load_vqvae_pretrained`` loads the first two into another network
    (``train.pretrained`` of the ``vqpt`` trainer).

``write_log`` holds ``{"path", "bytes", "seconds"}`` for each finished
write.
"""
from __future__ import annotations

import os
import shutil
import tarfile
import threading
import time

import torch
import torch.nn as nn

write_log: list = []

_pending = None  # the write in flight: a _Writer


class _Writer(threading.Thread):
    def __init__(self, path: str, tree: dict):
        super().__init__(daemon=True)
        self.path, self.tree, self.error = path, tree, None

    def run(self):
        try:
            _write(self.path, self.tree)
        except BaseException as e:  # noqa: BLE001  (raised by wait_for_saves)
            self.error = e


def _write(path: str, tree: dict):
    t0 = time.perf_counter()
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    write_log.append({"path": path, "bytes": os.path.getsize(path),
                      "seconds": time.perf_counter() - t0})


def wait_for_saves():
    """Block until the write in flight, if any, has finished; raise its
    error if it failed."""
    global _pending
    writer, _pending = _pending, None
    if writer is not None:
        writer.join()
        if writer.error is not None:
            raise writer.error


def _to_host(x, non_blocking: bool):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True, non_blocking=non_blocking and x.is_cuda)
    if isinstance(x, dict):
        out = type(x)((k, _to_host(v, non_blocking)) for k, v in x.items())
        if hasattr(x, "_metadata"):  # a state_dict's module versions
            out._metadata = x._metadata
        return out
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v, non_blocking) for v in x)
    return x


def _state(obj):
    return obj.state_dict() if isinstance(obj, (nn.Module, torch.optim.Optimizer)) else obj


def fetch_ckpt_tree(model_1, model_2, epoch, batch_idx, optimizer_1, optimizer_2,
                    include_optimizers: bool = True) -> dict:
    """The contract copied to the host.  Models and optimizers may be given
    as modules and optimizers or as their state dicts.
    ``include_optimizers=False`` copies models only (a light snapshot; the
    result cannot be written as a full contract)."""
    tree = {"model_1": _state(model_1), "model_2": _state(model_2),
            "epoch": int(epoch), "batch_idx": int(batch_idx)}
    if include_optimizers:
        tree["optimizer_1"] = _state(optimizer_1)
        tree["optimizer_2"] = _state(optimizer_2)
    return _host_copy(tree)


def _host_copy(tree: dict) -> dict:
    """``tree`` copied to the host: on the card non-blocking copies, then
    one synchronize."""
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    host = _to_host(tree, non_blocking=cuda)
    if cuda:
        torch.cuda.synchronize()  # the non-blocking copies have landed
    return host


def save_ckpoints(model_1, model_2, epoch, batch_idx, optimizer_1, optimizer_2,
                  filepath: str, async_save: bool = True, prefetched=None,
                  include_optimizers: bool = True):
    """Write the contract to ``filepath``.  ``prefetched``: a
    ``fetch_ckpt_tree`` result to write without copying again.
    ``include_optimizers=False`` writes a light snapshot; ``last.ckpt``
    must keep the full contract so that resume works (the trainer sees to
    that)."""
    tree = prefetched if prefetched is not None else fetch_ckpt_tree(
        model_1, model_2, epoch, batch_idx, optimizer_1, optimizer_2,
        include_optimizers=include_optimizers)
    if include_optimizers and "optimizer_1" not in tree:
        raise ValueError("prefetched tree has no optimizer state (fetched with "
                         "include_optimizers=False) but a full-contract write was "
                         "requested: fetch again with include_optimizers=True")
    if not include_optimizers:
        tree = {k: v for k, v in tree.items() if k not in ("optimizer_1", "optimizer_2")}
    _submit(filepath, tree, async_save)


def _submit(filepath: str, host_tree: dict, async_save: bool):
    """Write a host tree, in the background thread unless ``async_save`` is
    false, after the write in flight."""
    global _pending
    path = os.path.abspath(filepath)
    wait_for_saves()
    if not async_save:
        _write(path, host_tree)
        return
    _pending = _Writer(path, host_tree)
    _pending.start()


def save_tree(tree: dict, filepath: str, async_save: bool = True):
    """Write any tree of tensors, modules' state dicts and plain values (the
    supervised driver's ``{"model_1", "epoch"}``) to ``filepath`` through
    the same host copy and writer as ``save_ckpoints``."""
    _submit(filepath, _host_copy({k: _state(v) for k, v in tree.items()}), async_save)


def load_full(weights_path: str) -> dict:
    wait_for_saves()
    return torch.load(weights_path, map_location="cpu", weights_only=True)


def load_ckpoints(weights_path: str, istrain: bool):
    """``istrain``: ``(model_2, epoch, batch_idx, optimizer_1,
    optimizer_2)``, as the reference returns them; else ``model_1``."""
    ck = load_full(weights_path)
    if istrain:
        if "optimizer_1" not in ck:
            raise ValueError(f"{weights_path} is a light snapshot (no optimizer state, "
                             "cfg.train.light_snapshots): resume from last.ckpt, which "
                             "always keeps the full contract")
        return ck["model_2"], ck["epoch"], ck["batch_idx"], ck["optimizer_1"], ck["optimizer_2"]
    return ck["model_1"]


def latest_ckpt(save_dir: str):
    """The newest run's full-contract ``last.ckpt`` under ``save_dir``, the
    target of ``cfg.train.resume: "auto"``: each trainer invocation makes a
    fresh ``{project}_hybrid_N`` run directory, so recovery scans the
    previous runs for the most recent ``last.ckpt``.  None when there is
    nothing to resume from."""
    if not save_dir or not os.path.isdir(save_dir):
        return None
    best, best_t = None, -1.0
    for run in os.listdir(save_dir):
        p = os.path.join(save_dir, run, "ckpoints", "last.ckpt")
        if os.path.exists(p):
            t = os.path.getmtime(p)
            if t > best_t:
                best, best_t = p, t
    return best


def _vqvae_parts(model: nn.Module):
    """(encoder, codebooks, decoder) of ``model``: the U-Nets' ``core``, else
    the network itself (the VQ-VAEs: ``vqvaev2``'s per-stage ``codebooks``,
    ``vqvaev1``'s one ``codebook``)."""
    host = model.core if hasattr(model, "core") else model
    codebooks = host.codebooks if hasattr(host, "codebooks") else host.codebook
    return host.encoder, codebooks, host.decoder


def save_vqvae(model: nn.Module, epoch: int, ckpoints_dir: str):
    """Write ``{epoch}ep_encoder.ckpt`` (the encoder's state dict),
    ``{epoch}ep_codebook.ckpt`` (the codebooks' state dict: each VQ stage's
    codebook by its key in the codebook list, e.g. ``"2.embedding"``, or
    ``vqvaev1``'s ``"embedding"``) and ``{epoch}ep_decoder.ckpt`` (the
    decoder's state dict) under ``ckpoints_dir`` (made where missing), as
    ``torch.save`` dicts, synchronously.  A U-Net's parts sit under
    ``core``, a VQ-VAE's at its top level."""
    encoder, codebooks, decoder = _vqvae_parts(model)
    os.makedirs(ckpoints_dir, exist_ok=True)
    for name, part in (("encoder", encoder), ("codebook", codebooks), ("decoder", decoder)):
        save_tree(dict(part.state_dict()), os.path.join(ckpoints_dir, f"{epoch}ep_{name}.ckpt"),
                  async_save=False)


def load_vqvae_pretrained(model: nn.Module, encoder_ckpt: str, codebook_ckpt: str) -> nn.Module:
    """Load the encoder file of ``save_vqvae`` into ``model``'s encoder
    (strictly) and each codebook of the codebook file into the stage of the
    same key, where the model has it with the same shape; warns if no
    codebook matches.  Returns ``model``."""
    import warnings

    encoder, codebooks, _ = _vqvae_parts(model)
    encoder.load_state_dict(load_full(encoder_ckpt))
    target = codebooks.state_dict()
    matched = {k: v for k, v in load_full(codebook_ckpt).items()
               if k in target and tuple(target[k].shape) == tuple(v.shape)}
    if not matched:
        warnings.warn(f"no codebook of {codebook_ckpt} matches a stage of the network: "
                      "skipped", stacklevel=2)
    codebooks.load_state_dict(matched, strict=False)
    return model


def save_tar(target_path: str):
    head, name = os.path.split(target_path)
    with tarfile.open(os.path.join(head, name + ".tar.gz"), "w:gz") as t:
        t.add(target_path)
    shutil.rmtree(target_path)
