"""Serving path, counterpart of the JAX package's ``serving.py``.

* Images cross to the device as uint8 (B, H, W, 3) and labels come back as
  uint8 class ids (B, H, W); ``/255``, the optional bilinear score resize to
  ``output_hw`` and the argmax run on the device.
* ``half=True`` runs the forward under bf16 ``torch.autocast``; BN running
  stats and VQ codebooks stay f32, and the VQ assignment itself is f32.
* ``quant="int8"`` (which implies ``half``) keeps every float parameter
  with two or more dims on the device as int8 with one f32 scale per
  output channel (``quantize_int8``), and the 1-D parameters as bf16, as
  the JAX package's ``_quantize_params_int8`` does; every forward
  dequantises them to bf16 (``q.to(bf16) * scale.to(bf16)``) and runs the
  network on them with ``torch.func.functional_call``.  Buffers (BN
  running stats, VQ codebooks) stay f32.
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

import copy
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .device import resolve_device
from .models.layers import resize_bilinear
from .models.networks import make_model


def output_axis(module: nn.Module, weight: torch.Tensor) -> int:
    """The axis of ``weight`` (a parameter of ``module`` with >= 2 dims) that
    is the last axis of the JAX package's layout, its output channel:
    ``utils/convert.py`` maps flax's HWIO conv and (in, out) dense kernels
    to torch's OIHW and (out, in) (axis 0), a transposed conv's kernel to
    (in, out, kH, kW) (axis 1), and keeps any other table, such as a (K, C)
    embedding, as it is (its last axis)."""
    if isinstance(module, nn.modules.conv._ConvTransposeNd):
        return 1
    if isinstance(module, (nn.modules.conv._ConvNd, nn.Linear)):
        return 0
    return weight.dim() - 1


@torch.no_grad()
def quantize_int8(weight: torch.Tensor, axis: int):
    """Symmetric int8 with one scale per index of ``axis``: ``scale =
    amax / 127`` where the channel's largest magnitude is above 0, else 1;
    ``q = clip(round(w / scale), -127, 127)``, rounding half to even.
    Returns (q int8, scale f32 shaped to broadcast against ``weight``)."""
    w = weight.float()
    dims = tuple(d for d in range(w.dim()) if d != axis)
    amax = torch.amax(w.abs(), dim=dims, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """bf16 weights from int8 and their scales, as the JAX package computes
    them inside its forward."""
    return q.to(torch.bfloat16) * scale.to(torch.bfloat16)


class _Int8Weights:
    """The parameters of ``model`` quantized for serving on ``device``: int8
    and scales for the tensors with >= 2 dims, bf16 for the others.
    ``shell`` is a copy of ``model`` whose parameters are empty
    placeholders, so that no float copy of a weight stays on the device."""

    def __init__(self, model: nn.Module, device):
        self.quantized = {}  # name -> (q, scale, keep bf16 for a conv or a linear)
        self.vectors = {}  # name -> bf16 value
        placeholders = {}
        for mod_name, module in model.named_modules():
            for p_name, p in module.named_parameters(recurse=False):
                name = f"{mod_name}.{p_name}" if mod_name else p_name
                placeholders[id(p)] = nn.Parameter(torch.empty(0, device=device),
                                                   requires_grad=False)
                if p.is_floating_point() and p.dim() >= 2:
                    q, scale = quantize_int8(p.detach(), output_axis(module, p))
                    as_bf16 = isinstance(module, (nn.modules.conv._ConvNd, nn.Linear))
                    self.quantized[name] = (q.to(device), scale.to(device), as_bf16)
                else:
                    self.vectors[name] = p.detach().to(device, torch.bfloat16)
        self.shell = copy.deepcopy(model, memo=placeholders).to(device).eval()

    def params(self) -> dict:
        """Every parameter for one forward: the dequantised bf16 weights
        (given as f32 where no conv or linear reads them, the same values)
        and the 1-D parameters' bf16 values as f32."""
        out = {name: v.float() for name, v in self.vectors.items()}
        for name, (q, scale, as_bf16) in self.quantized.items():
            w = dequantize_int8(q, scale)
            out[name] = w if as_bf16 else w.float()
        return out

    def nbytes(self) -> int:
        """Bytes of the quantized parameters on the device."""
        return (sum(q.numel() * q.element_size() + s.numel() * s.element_size()
                    for q, s, _ in self.quantized.values())
                + sum(v.numel() * v.element_size() for v in self.vectors.values()))


class Predictor:
    """Fixed-shape segmentation predictor.

    model:      a network from :func:`make_model` (its forward returns logits
                NCHW, or a tuple with logits first).
    input_hw:   (H, W) the model consumes: ``cfg.resize``.
    batch_size: serving batch; a partial final batch is padded with zeros.
    output_hw:  if given, logits are bilinearly resized to it before the
                argmax; None = argmax at model resolution.
    half:       bf16 autocast (default True).
    quant:      "int8": weight-only int8 with per-output-channel scales,
                dequantised to bf16 inside every forward; implies ``half``.
                The caller's model is left as it was.
    device:     "cuda" unless the caller asks for "cpu".
    mesh, spatial: multi-card serving, not ported yet.
    """

    def __init__(self, model, *, input_hw: Tuple[int, int], batch_size: int = 1,
                 output_hw: Optional[Tuple[int, int]] = None, half: bool = True,
                 device="cuda", mesh=None, spatial: bool = False, quant: Optional[str] = None):
        if quant not in (None, "int8"):
            raise ValueError(f"quant must be None or 'int8', got {quant!r}")
        if mesh is not None or spatial:
            raise NotImplementedError(
                "mesh and spatial serving are not ported yet "
                "(ROADMAP.md, queue 1, item 12)")
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.input_hw = tuple(input_hw)
        self.output_hw = tuple(output_hw) if output_hw is not None else None
        self.int8 = None
        if quant == "int8":
            self.int8 = _Int8Weights(model, self.device)
            self.model = self.int8.shell
            half = True
        else:
            self.model = model.to(self.device).eval()
        self.half = bool(half)
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
            if self.int8 is not None:
                out = torch.func.functional_call(self.model, self.int8.params(), (x,))
            else:
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
