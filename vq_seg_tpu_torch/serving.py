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
* ``mesh=[devices]`` serves with one replica of the weights per device
  from one process, each batch split in order over the replicas.
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


class _Replica:
    """One copy of the weights on one device, with its two pinned host
    slots on a card (with one batch in flight, a slot is rewritten only
    after the fetch of the batch that used it waited on its event)."""

    def __init__(self, model, device, batch: int, input_hw, int8: bool):
        self.device = device
        self.int8 = _Int8Weights(model, device) if int8 else None
        self.model = self.int8.shell if int8 else model.to(device).eval()
        self.slot = 0
        self.host_in = self.host_out = None
        if device.type == "cuda":
            self.host_in = [torch.zeros((batch, *input_hw, 3), dtype=torch.uint8).pin_memory()
                            for _ in range(2)]
            self.host_out = [None, None]


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
    mesh:       a list of devices (``["cuda:0", "cuda:1"]``): one process
                drives one replica of the weights on each, the JAX
                package's batch-sharded mesh serving.  ``batch_size`` must
                divide by the number of devices; each batch is split in
                order over the replicas and the labels come back in order.
                ``device`` is then ignored.
    spatial:    batch-1 spatial serving, not ported yet.
    """

    def __init__(self, model, *, input_hw: Tuple[int, int], batch_size: int = 1,
                 output_hw: Optional[Tuple[int, int]] = None, half: bool = True,
                 device="cuda", mesh=None, spatial: bool = False, quant: Optional[str] = None):
        if quant not in (None, "int8"):
            raise ValueError(f"quant must be None or 'int8', got {quant!r}")
        if spatial:
            raise NotImplementedError(
                "spatial serving (per-layer halo exchange) is not ported yet "
                "(ROADMAP.md, queue 1, item 21)")
        devices = [resolve_device(d) for d in (mesh if mesh is not None else [device])]
        self.batch_size = int(batch_size)
        if self.batch_size % len(devices):
            raise ValueError(f"batch_size {self.batch_size} must divide by the {len(devices)} "
                             "devices of the mesh")
        self.device = devices[0]
        self.input_hw = tuple(input_hw)
        self.output_hw = tuple(output_hw) if output_hw is not None else None
        per = self.batch_size // len(devices)
        self.replicas = [_Replica(model if i == 0 else copy.deepcopy(model), d, per,
                                  self.input_hw, quant == "int8")
                         for i, d in enumerate(devices)]
        self.model, self.int8 = self.replicas[0].model, self.replicas[0].int8
        self.half = bool(half) or quant == "int8"

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
    def logits(self, img_u8: torch.Tensor, replica: Optional[_Replica] = None) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the device -> f32 logits (B, classes, oh, ow),
        by ``replica`` (default the first)."""
        rep = replica or self.replicas[0]
        x = img_u8.permute(0, 3, 1, 2).contiguous().float() / 255.0
        with torch.autocast(rep.device.type, dtype=torch.bfloat16, enabled=self.half):
            if rep.int8 is not None:
                out = torch.func.functional_call(rep.model, rep.int8.params(), (x,))
            else:
                out = rep.model(x)
        logits = (out[0] if isinstance(out, tuple) else out).float()
        if self.output_hw is not None and tuple(logits.shape[-2:]) != self.output_hw:
            logits = resize_bilinear(logits, self.output_hw)
        return logits

    def _forward(self, img_u8: torch.Tensor, replica: Optional[_Replica] = None) -> torch.Tensor:
        return torch.argmax(self.logits(img_u8, replica), dim=1).to(torch.uint8)

    # -- dispatch/fetch split (predict_stream pipelines across it) ---------

    def _dispatch(self, imgs: np.ndarray):
        """Enqueue one forward on every replica; returns a handle for
        ``_fetch``."""
        imgs = np.asarray(imgs)
        if imgs.ndim != 4 or imgs.shape[1:3] != self.input_hw or imgs.shape[3] != 3:
            raise ValueError(f"expected (B, {self.input_hw[0]}, {self.input_hw[1]}, 3) "
                             f"uint8, got {imgs.shape}")
        n = imgs.shape[0]
        if n > self.batch_size:
            raise ValueError(f"batch {n} > serving batch_size {self.batch_size}")
        imgs = torch.from_numpy(np.ascontiguousarray(imgs, dtype=np.uint8))
        per = self.batch_size // len(self.replicas)
        parts = []
        for i, rep in enumerate(self.replicas):
            rows = imgs[i * per:(i + 1) * per]  # this replica's images, the tail zero
            if rep.device.type != "cuda":
                dev = torch.zeros((per, *self.input_hw, 3), dtype=torch.uint8)
                dev[:rows.shape[0]] = rows
                parts.append((self._forward(dev, rep), None))
                continue
            slot = rep.slot
            rep.slot ^= 1
            host = rep.host_in[slot]
            host[:rows.shape[0]] = rows
            host[rows.shape[0]:] = 0
            dev = host.to(rep.device, non_blocking=True)
            labels = self._forward(dev, rep)
            out = rep.host_out[slot]
            if out is None or out.shape != labels.shape:
                out = rep.host_out[slot] = torch.empty(labels.shape,
                                                       dtype=torch.uint8).pin_memory()
            out.copy_(labels, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(rep.device))
            parts.append((out, event))
        return parts, n

    @staticmethod
    def _fetch(handle) -> np.ndarray:
        parts, n = handle
        for _, event in parts:
            if event is not None:
                event.synchronize()
        if len(parts) == 1:
            return parts[0][0][:n].numpy().copy()
        return np.concatenate([labels.numpy() for labels, _ in parts])[:n]

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
