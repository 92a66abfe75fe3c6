"""Serving path, counterpart of the JAX package's ``serving.py``.

* Images cross to the device as uint8 (B, H, W, 3) and labels come back as
  uint8 class ids (B, H, W); ``/255``, the optional bilinear score resize to
  ``output_hw`` and the argmax run on the device.
* ``half=True`` runs the forward under bf16 ``torch.autocast``; BN running
  stats and VQ codebooks stay f32, and the VQ assignment itself is f32.
* ``predict_stream`` keeps one batch in flight: batch k+1 is enqueued
  before batch k's labels are read.  On the card the host buffers are
  pinned, copies are ``non_blocking`` and each batch records an event that
  its fetch waits on.
* PyTorch runs eagerly, so there is no ahead-of-time compile.

Example::

    pred = Predictor.from_checkpoint(cfg, "last.pt", batch_size=8)
    labels = pred(imgs_uint8)                 # (B, H, W) uint8 class ids
    for lab in pred.predict_stream(batches):  # pipelined
        ...
"""
from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device
from .models.layers import resize_bilinear
from .models.networks import make_model


class Predictor:
    """Fixed-shape segmentation predictor.

    model:      a network from :func:`make_model` (its forward returns logits
                NCHW, or a tuple with logits first).
    input_hw:   (H, W) the model consumes: ``cfg.resize``.
    batch_size: serving batch; a partial final batch is padded with zeros.
    output_hw:  if given, logits are bilinearly resized to it before the
                argmax; None = argmax at model resolution.
    half:       bf16 autocast (default True).
    device:     "cuda" unless the caller asks for "cpu".
    """

    def __init__(self, model, *, input_hw: Tuple[int, int], batch_size: int = 1,
                 output_hw: Optional[Tuple[int, int]] = None, half: bool = True,
                 device="cuda", mesh=None, spatial: bool = False, quant: Optional[str] = None):
        if quant not in (None, "int8"):
            raise ValueError(f"quant must be None or 'int8', got {quant!r}")
        if quant is not None or mesh is not None or spatial:
            raise NotImplementedError(
                "int8, mesh and spatial serving are not ported yet "
                "(ROADMAP.md, queue 1, 'Serving options')")
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.input_hw = tuple(input_hw)
        self.output_hw = tuple(output_hw) if output_hw is not None else None
        self.half = bool(half)
        self.model = model.to(self.device).eval()
        self._cuda = self.device.type == "cuda"
        self._slot = 0
        self._host_in = self._host_out = None
        if self._cuda:
            # two slots: with one batch in flight, a slot is rewritten only
            # after the fetch of the batch that used it waited on its event
            self._host_in = [torch.zeros((self.batch_size, *self.input_hw, 3),
                                         dtype=torch.uint8).pin_memory() for _ in range(2)]
            self._host_out = [None, None]

    @classmethod
    def from_checkpoint(cls, cfg, weights_path: str, *, device="cuda", **kw):
        """Build from a config (``cfg.model`` schema) and a ``torch.save``
        file: the checkpoint contract ``{model_1, ...}`` (``model_1`` is
        used) or a bare state_dict."""
        device = resolve_device(device)
        model = make_model(cfg.model, device="cpu")
        ck = torch.load(weights_path, map_location="cpu", weights_only=True)
        model.load_state_dict(ck["model_1"] if "model_1" in ck else ck)
        kw.setdefault("input_hw", (cfg.resize, cfg.resize))
        return cls(model, device=device, **kw)

    @torch.no_grad()
    def logits(self, img_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the device -> f32 logits (B, classes, oh, ow)."""
        x = img_u8.permute(0, 3, 1, 2).contiguous().float() / 255.0
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.half):
            out = self.model(x)
        logits = (out[0] if isinstance(out, tuple) else out).float()
        if self.output_hw is not None and tuple(logits.shape[-2:]) != self.output_hw:
            logits = resize_bilinear(logits, self.output_hw)
        return logits

    def _forward(self, img_u8: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.logits(img_u8), dim=1).to(torch.uint8)

    # -- dispatch/fetch split (predict_stream pipelines across it) ---------

    def _dispatch(self, imgs: np.ndarray):
        """Enqueue one forward; returns a handle for ``_fetch``."""
        imgs = np.asarray(imgs)
        if imgs.ndim != 4 or imgs.shape[1:3] != self.input_hw or imgs.shape[3] != 3:
            raise ValueError(f"expected (B, {self.input_hw[0]}, {self.input_hw[1]}, 3) "
                             f"uint8, got {imgs.shape}")
        n = imgs.shape[0]
        if n > self.batch_size:
            raise ValueError(f"batch {n} > serving batch_size {self.batch_size}")
        imgs = torch.from_numpy(np.ascontiguousarray(imgs, dtype=np.uint8))
        if not self._cuda:
            dev = torch.zeros((self.batch_size, *self.input_hw, 3), dtype=torch.uint8)
            dev[:n] = imgs
            return self._forward(dev), n, None
        slot = self._slot
        self._slot ^= 1
        host = self._host_in[slot]
        host[:n] = imgs
        host[n:] = 0
        dev = host.to(self.device, non_blocking=True)
        labels = self._forward(dev)
        out = self._host_out[slot]
        if out is None or out.shape != labels.shape:
            out = self._host_out[slot] = torch.empty(labels.shape, dtype=torch.uint8).pin_memory()
        out.copy_(labels, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return out, n, event

    @staticmethod
    def _fetch(handle) -> np.ndarray:
        labels, n, event = handle
        if event is not None:
            event.synchronize()
        return labels[:n].numpy().copy()

    def __call__(self, imgs: np.ndarray) -> np.ndarray:
        """(B <= batch_size, H, W, 3) uint8 -> (B, oh, ow) uint8 class ids."""
        return self._fetch(self._dispatch(imgs))

    def predict_stream(self, batches: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Yield labels for an iterable of image batches with one batch kept
        in flight (dispatch k+1 before fetching k)."""
        pending = None
        for imgs in batches:
            handle = self._dispatch(imgs)
            if pending is not None:
                yield self._fetch(pending)
            pending = handle
        if pending is not None:
            yield self._fetch(pending)
