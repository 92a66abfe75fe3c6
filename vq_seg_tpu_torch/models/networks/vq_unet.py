"""The VQ U-Net family, counterpart of the JAX package's
``models/networks/vq_unet.py``: ``VQUnetCore``, ``ConvMixer``,
``self_entropy``, ``VQUnet_v2``, the prototype-loss networks on the
``_PTNet`` skeleton (the flagship ``VQRePTUnet1x1v2`` and the ``reptcps``
family ``VQRePTUnet1x1``, ``VQRePTUnetDouble1x1``, ``VQRePTUnet``,
``VQReTemPTUnet``, ``VQReEuPTUnet``, ``VQOnlyPTUnet1x1``), the
(x, gt)-signature networks of ``vqpt`` (``VQPTUnet``, ``VQEuPTUnet``,
``VQNEDPTUnet``) and the attention networks of ``plaincps``/``objcps`` (``VQATUnet``, ``VQCANet``,
``VQCANetv2/v3/v4``, ``DRSAVQUnet``, ``VQPatchUNet``, ``VQIMDBNet``).

encoder stages[1:] -> per-stage VQ (commitment loss summed and divided by
the number of stages) -> UnetDecoder -> head -> x2 align-corners upsample.
In training with ``gt`` the prototype loss runs on the decoder output
before the head; otherwise the network returns ``proto = 0``.  The
angular-head networks are in ``unet.py``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..encoders import make_encoder
from ..layers import ConvPad, batch_norm, torch_conv_default, upsample_bilinear_ac
from ..modules.attention import CCA, DRSAM, IMDB, DualAttention
from ..modules.decoder import UnetDecoder
from ..modules.prototype import (EuclideanPrototypeLoss, LearnableEuclideanPrototypeLoss,
                                 NEDPrototypeLoss, OnlyCWPrototypeLoss, PrototypeLoss,
                                 ReliableEuclideanPrototypeLoss, ReliablePrototypeLoss,
                                 ReliablePrototypeLossv2, StableTemperaturedPrototypeLoss)
from ..modules.vector_quantizer import make_vq_module, quantize_stages
from . import register


PRE_VQ = (None, "dual_all", "cca_deepest", "imdb_deepest", "drsam_identity")


def _decoder_channels(encoder_channels, decoder_channels):
    """Default plan: halved encoder channels, reversed."""
    if decoder_channels is not None:
        return tuple(decoder_channels)
    return tuple(i // 2 for i in encoder_channels[1:])[::-1]


def self_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Per-pixel predictive entropy of (N, C, h, w) logits, detached and
    flat in (n, h, w) order, the order ``_flatten_with_gt`` gives the rows."""
    prob = torch.softmax(logits.detach().float(), dim=1)
    return -torch.sum(prob * torch.log(prob + 1e-10), dim=1).reshape(-1)


class ConvMixer(nn.Module):
    """Patch-embed + depthwise-residual mixer stem (``VQPatchUNet``): convs
    with biases and torch's default init, each followed by ReLU then BN."""

    def __init__(self, dim: int, depth: int = 3, kernel_size: int = 9, patch_size: int = 2,
                 in_channels: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed = ConvPad(in_channels, dim, patch_size, patch_size, 0, bias=True,
                             init=torch_conv_default, generator=generator)
        self.embed_bn = batch_norm(dim)
        self.dw = nn.ModuleList(
            ConvPad(dim, dim, kernel_size, 1, kernel_size // 2, groups=dim, bias=True,
                    init=torch_conv_default, generator=generator) for _ in range(depth))
        self.dw_bn = nn.ModuleList(batch_norm(dim) for _ in range(depth))
        self.pw = nn.ModuleList(ConvPad(dim, dim, 1, bias=True, init=torch_conv_default,
                                        generator=generator) for _ in range(depth))
        self.pw_bn = nn.ModuleList(batch_norm(dim) for _ in range(depth))

    def forward(self, x):
        x = self.embed_bn(F.relu(self.embed(x)))
        for dw, dw_bn, pw, pw_bn in zip(self.dw, self.dw_bn, self.pw, self.pw_bn):
            x = x + dw_bn(F.relu(dw(x)))
            x = pw_bn(F.relu(pw(x)))
        return x


class VQUnetCore(nn.Module):
    """Shared encoder -> [attention] -> VQ -> decoder trunk.

    ``pre_vq`` puts attention on the encoder stages before the VQ:
    "dual_all" (``DualAttention`` on every stage, ``att_{i}``),
    "cca_deepest" (``CCA`` on the deepest, ``cca``), "imdb_deepest"
    (``IMDB`` on the deepest, ``imdb``) or "drsam_identity" (``DRSAM`` on
    each stage whose VQ passes through, ``drsam_{i}``).  ``decoder_cca``
    flags a ``CCA`` after decoder blocks; ``stem="convmixer"`` replaces the
    resnet stem with a ``ConvMixer`` of ``mixer_depth`` blocks."""

    def __init__(self, encoder_name: str, vq_cfg=None, in_channels: int = 3,
                 decoder_channels: Optional[Sequence[int]] = None, depth: int = 5,
                 padding_mode: str = "zeros", bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None, pre_vq: Optional[str] = None,
                 decoder_cca: Optional[Sequence[bool]] = None, stem: str = "default",
                 mixer_depth: int = 3, subpixel_tail: bool = False):
        super().__init__()
        if pre_vq not in PRE_VQ:
            raise ValueError(f"pre_vq must be one of {PRE_VQ}, got {pre_vq!r}")
        stem_mod = (ConvMixer(64, mixer_depth, in_channels=in_channels, generator=generator)
                    if stem == "convmixer" else None)
        self.encoder, enc_ch = make_encoder(encoder_name, in_channels, depth,
                                            padding_mode=padding_mode, generator=generator,
                                            custom_stem=stem_mod)
        self.codebooks = (make_vq_module(vq_cfg, list(enc_ch), depth, generator)
                          if vq_cfg is not None else None)
        stage_ch = list(enc_ch[1:])
        self.pre_vq = pre_vq
        if pre_vq == "dual_all":
            for i, ch in enumerate(stage_ch):
                self.add_module(f"att_{i}", DualAttention(ch, generator))
        elif pre_vq == "cca_deepest":
            self.cca = CCA(stage_ch[-1], stage_ch[-1], generator)
        elif pre_vq == "imdb_deepest":
            self.imdb = IMDB(stage_ch[-1], generator=generator)
        elif pre_vq == "drsam_identity" and vq_cfg is not None:
            self.drsam_stages = [i for i, k in enumerate(dict(vq_cfg)["num_embeddings"])
                                 if k == 0]
            for i in self.drsam_stages:
                self.add_module(f"drsam_{i}", DRSAM(stage_ch[i], generator=generator))
        self.decoder_channels = _decoder_channels(enc_ch, decoder_channels)
        self.decoder = UnetDecoder(enc_ch, self.decoder_channels, bn_eps, bn_momentum,
                                   cca=decoder_cca, subpixel_tail=subpixel_tail,
                                   generator=generator)

    def _features(self, x):
        """The encoder stage outputs (without the input) after the pre-VQ
        attention."""
        features = list(self.encoder(x)[1:])
        if self.pre_vq == "dual_all":
            features = [getattr(self, f"att_{i}")(f) for i, f in enumerate(features)]
        elif self.pre_vq == "cca_deepest":
            features[-1] = self.cca(features[-1])
        elif self.pre_vq == "imdb_deepest":
            features[-1] = self.imdb(features[-1])
        elif self.pre_vq == "drsam_identity" and self.codebooks is not None:
            for i in self.drsam_stages:
                features[i] = getattr(self, f"drsam_{i}")(features[i])
        return features

    @torch.no_grad()
    def init_codebook_(self, x: torch.Tensor, generator: torch.Generator):
        """k-means init phase: every VQ stage clusters its own (post-
        attention) encoder stage output, stage by stage from the shallowest.
        The encoder runs in the module's current mode (eval: running BN
        stats)."""
        if self.codebooks is None:
            return
        for vq, f in zip(self.codebooks, self._features(x)):
            vq.init_codebook_(f, generator)

    def forward(self, x, train: bool = False, init_codebook: bool = False,
                generator: Optional[torch.Generator] = None, return_features: bool = False):
        """``train`` selects the STE and the commitment loss; the BN mode is
        the module's own (``.train()``/``.eval()``).  ``init_codebook=True``
        runs each VQ stage's k-means on its features in this forward, from
        ``generator``, stage by stage from the shallowest.
        ``return_features`` also returns the quantized stage outputs."""
        features = self._features(x)
        commit, usage_vec = quantize_stages(self.codebooks, features, x, train, init_codebook,
                                            generator)
        dec = self.decoder(features)
        if return_features:
            return dec, commit, usage_vec, features
        return dec, commit, usage_vec


def _vq_head(channels: int, num_classes: int, generator) -> ConvPad:
    """The JAX package's ``_VQHead`` conv: 3x3 with bias, torch's default
    init."""
    return ConvPad(channels, num_classes, 3, 1, 1, bias=True, init=torch_conv_default,
                   generator=generator)


def _head_out(head: nn.Module, dec, upsampling: int):
    out = head(dec)
    return upsample_bilinear_ac(out, scale=upsampling) if upsampling > 1 else out


@register("vqunet_v2")
class VQUnet_v2(nn.Module):
    """Per-stage VQ, zero-padded encoder, a 3x3 head with bias, the x2
    upsample, then the softmax over classes.  ``forward(x, train=False,
    init_codebook=False, generator=None)`` -> (out, commit, usage)."""

    def __init__(self, encoder_name: str, num_classes: int, vq_cfg,
                 encoder_weights: Optional[str] = None, in_channels: int = 3,
                 decoder_channels: Optional[Sequence[int]] = None, depth: int = 5,
                 upsampling: int = 2, bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsampling = upsampling
        self.core = VQUnetCore(encoder_name, vq_cfg, in_channels, decoder_channels, depth,
                               bn_eps=bn_eps, bn_momentum=bn_momentum, generator=generator)
        self.segmentation_head = _vq_head(self.core.decoder_channels[-1], num_classes, generator)

    def init_codebook_(self, x: torch.Tensor, generator: torch.Generator):
        self.core.init_codebook_(x, generator)

    def forward(self, x, train: bool = False, init_codebook: bool = False,
                generator: Optional[torch.Generator] = None):
        dec, commit, usage = self.core(x, train=train, init_codebook=init_codebook,
                                       generator=generator)
        out = _head_out(self.segmentation_head, dec, self.upsampling)
        return torch.softmax(out, dim=1), commit, usage


@register("vqunet_v1")
class VQUnet_v1(nn.Module):
    """VQ at the deepest stage only: ``vq_cfg.num_embeddings`` becomes
    ``[0] * (depth - 1) + [K]`` with K its last entry (or the int itself);
    a zero-padded encoder, a 3x3 head with bias and the x2 upsample, no
    softmax.  ``forward(x, train=False, init_codebook=False,
    generator=None)`` -> (out, commit, usage)."""

    def __init__(self, encoder_name: str, num_classes: int, vq_cfg,
                 encoder_weights: Optional[str] = None, in_channels: int = 3,
                 decoder_channels: Optional[Sequence[int]] = None, depth: int = 5,
                 upsampling: int = 2, bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = dict(vq_cfg)
        k = cfg["num_embeddings"]
        cfg["num_embeddings"] = [0] * (depth - 1) + [k[-1] if isinstance(k, (list, tuple)) else k]
        self.upsampling = upsampling
        self.core = VQUnetCore(encoder_name, cfg, in_channels, decoder_channels, depth,
                               bn_eps=bn_eps, bn_momentum=bn_momentum, generator=generator)
        self.segmentation_head = _vq_head(self.core.decoder_channels[-1], num_classes, generator)

    def init_codebook_(self, x: torch.Tensor, generator: torch.Generator):
        self.core.init_codebook_(x, generator)

    def forward(self, x, train: bool = False, init_codebook: bool = False,
                generator: Optional[torch.Generator] = None):
        dec, commit, usage = self.core(x, train=train, init_codebook=init_codebook,
                                       generator=generator)
        return _head_out(self.segmentation_head, dec, self.upsampling), commit, usage


class _PTNet(nn.Module):
    """Skeleton of the prototype-loss U-Nets: the reflect-padded trunk, a
    head chosen by ``head_kernel``/``head_bias``/``head_layers`` and the
    prototype loss chosen by ``proto_kind`` (None: none); ``subpixel_tail``
    reaches the decoder (``UnetDecoder``).  ``encoder_weights`` names
    pretrained weights that are never fetched here: the weights come from a
    checkpoint or from the trainer's state factory."""

    head_kernel = 3
    head_bias = True
    head_layers = 1
    proto_kind = "reliable"

    def __init__(self, encoder_name: str, num_classes: int, vq_cfg, margin: float = 1.5,
                 scale: float = 1.0, use_feature: bool = False,
                 encoder_weights: Optional[str] = None, in_channels: int = 3,
                 decoder_channels: Optional[Sequence[int]] = None, depth: int = 5,
                 upsampling: int = 2, pt_init: str = "kmeans", t: float = 0.1,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1, subpixel_tail: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.upsampling = upsampling
        self.core = VQUnetCore(encoder_name, vq_cfg, in_channels, decoder_channels, depth,
                               padding_mode="reflect", bn_eps=bn_eps, bn_momentum=bn_momentum,
                               generator=generator, subpixel_tail=subpixel_tail)
        dec_ch = self.core.decoder_channels[-1]
        self.segmentation_head = self._head(dec_ch, num_classes, generator)
        self.prototype_loss = self._proto(num_classes, dec_ch, pt_init, use_feature, margin, scale,
                                          t, generator)

    def _head(self, channels: int, num_classes: int, generator):
        if self.head_layers == 2:
            # two bias-free 1x1 convs with the kaiming-normal init
            return nn.Sequential(
                ConvPad(channels, channels, 1, bias=False, generator=generator),
                ConvPad(channels, num_classes, 1, bias=False, generator=generator))
        return ConvPad(channels, num_classes, self.head_kernel, 1, self.head_kernel // 2,
                       bias=self.head_bias, init=torch_conv_default, generator=generator)

    def _proto(self, num_classes, channels, pt_init, use_feature, margin, scale, t, generator):
        kw = dict(num_classes=num_classes, embedding_dim=channels, pt_init=pt_init,
                  use_feature=use_feature, generator=generator)
        if self.proto_kind is None:  # no prototype loss (``nopt``)
            return None
        if self.proto_kind == "reliable_v2":
            return ReliablePrototypeLossv2(margin=margin, scale=scale, **kw)
        if self.proto_kind == "reliable":
            return ReliablePrototypeLoss(margin=margin, scale=scale, **kw)
        if self.proto_kind == "stable_temperatured":
            return StableTemperaturedPrototypeLoss(t=t, **kw)
        if self.proto_kind == "reliable_euclidean":
            # the JAX package passes pt_init twice here and raises in every
            # train forward with gt (ROADMAP.md section 3); it is passed once
            return ReliableEuclideanPrototypeLoss(**kw)
        if self.proto_kind == "only_cw":
            return OnlyCWPrototypeLoss(margin=margin, scale=scale, **kw)
        if self.proto_kind == "prototype":
            return PrototypeLoss(margin=margin, scale=scale, **kw)
        if self.proto_kind == "ned":
            return NEDPrototypeLoss(**kw)
        raise ValueError(self.proto_kind)

    def init_codebook_(self, x: torch.Tensor, generator: torch.Generator):
        self.core.init_codebook_(x, generator)


@register("vqreptunet1x1v2")
class VQRePTUnet1x1v2(_PTNet):
    """Flagship: bias-free 1x1 head and the confidence-masked
    ``ReliablePrototypeLossv2``.  ``forward(x, gt=None, th=None,
    train=False, ...)`` -> (out, commit, usage, proto)."""

    head_kernel = 1
    head_bias = False
    proto_kind = "reliable_v2"

    def forward(self, x, gt=None, th=None, train: bool = False, init_codebook: bool = False,
                init_protos: bool = False, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        """``gt``: (N, H, W) labels or the other model's (N, C, H, W) score
        map, used with ``train``; ``th`` masks a score map's pixels.
        ``init_codebook``/``init_protos`` run the k-means init phases in this
        forward from ``generator``.  ``return_features`` returns the decoder
        output in place of the prototype loss."""
        dec, commit, usage = self.core(x, train=train, init_codebook=init_codebook,
                                       generator=generator)
        out = self.segmentation_head(dec)
        proto = x.new_zeros((), dtype=torch.float32)
        if train and gt is not None and not return_features:
            proto = self.prototype_loss(dec, gt, th, init_protos=init_protos, generator=generator)
        if self.upsampling > 1:
            out = upsample_bilinear_ac(out, scale=self.upsampling)
        if return_features:
            return out, commit, usage, dec
        return out, commit, usage, proto


@register("vqreptunet1x1")
class VQRePTUnet1x1(_PTNet):
    """1x1 bias-free head and ``ReliablePrototypeLoss``, whose rows are
    filtered by the entropy of the network's own prediction.  ``forward(x,
    gt=None, percent=None, train=False, init_codebook=False,
    init_protos=False, generator=None)`` -> (out, commit, usage, proto)."""

    head_kernel = 1
    head_bias = False

    def forward(self, x, gt=None, percent=None, train: bool = False,
                init_codebook: bool = False, init_protos: bool = False,
                generator: Optional[torch.Generator] = None):
        """``gt``: (N, H, W) integer labels, used with ``train``;
        ``percent``: the entropy percentile below which rows are kept."""
        dec, commit, usage = self.core(x, train=train, init_codebook=init_codebook,
                                       generator=generator)
        out = self.segmentation_head(dec)
        proto = x.new_zeros((), dtype=torch.float32)
        if train and gt is not None:
            proto = self.prototype_loss(dec, gt, percent, self_entropy(out),
                                        init_protos=init_protos, generator=generator)
        if self.upsampling > 1:
            out = upsample_bilinear_ac(out, scale=self.upsampling)
        return out, commit, usage, proto


@register("vqreptunetdouble1x1")
class VQRePTUnetDouble1x1(VQRePTUnet1x1):
    """Two bias-free 1x1 convs as the head."""

    head_layers = 2


@register("vqreptunet")
class VQRePTUnet(VQRePTUnet1x1):
    """A 3x3 head with bias."""

    head_kernel = 3
    head_bias = True


@register("vqretemptunet")
class VQReTemPTUnet(VQRePTUnet1x1):
    """``StableTemperaturedPrototypeLoss`` at temperature ``t``."""

    proto_kind = "stable_temperatured"


@register("vqreeuptunet")
class VQReEuPTUnet(VQRePTUnet1x1):
    """``ReliableEuclideanPrototypeLoss``."""

    proto_kind = "reliable_euclidean"


@register("vqonlyptunet1x1")
class VQOnlyPTUnet1x1(VQRePTUnet1x1):
    """``OnlyCWPrototypeLoss``: crop and weed prototypes only."""

    proto_kind = "only_cw"


@register("vqptunet")
class VQPTUnet(_PTNet):
    """``PrototypeLoss`` (the detached-table ArcFace CE) on the decoder
    output and a 3x3 head with bias, no softmax.  ``forward(x, gt=None,
    train=False, init_codebook=False, init_protos=False, generator=None)``
    -> (out, commit, usage, proto)."""

    proto_kind = "prototype"
    head_softmax = False

    def forward(self, x, gt=None, train: bool = False, init_codebook: bool = False,
                init_protos: bool = False, generator: Optional[torch.Generator] = None):
        """``gt``: (N, H, W) integer labels (or the other model's argmax
        pseudo-labels), used with ``train``."""
        dec, commit, usage = self.core(x, train=train, init_codebook=init_codebook,
                                       generator=generator)
        proto = x.new_zeros((), dtype=torch.float32)
        if train and gt is not None:
            proto = self.prototype_loss(dec, gt, init_protos=init_protos, generator=generator)
        out = self.segmentation_head(dec)
        if self.head_softmax:
            out = torch.softmax(out, dim=1)
        if self.upsampling > 1:
            out = upsample_bilinear_ac(out, scale=self.upsampling)
        return out, commit, usage, proto


@register("vqeuptunet")
class VQEuPTUnet(VQPTUnet):
    """``LearnableEuclideanPrototypeLoss`` (``learnable_alpha``, the
    default) or ``EuclideanPrototypeLoss``, both at their own k-means init
    (the network's ``pt_init`` is not passed, as in the JAX package), and
    the softmax over classes after the 3x3 head."""

    head_softmax = True

    def __init__(self, *args, learnable_alpha: bool = True, **kw):
        self.learnable_alpha = learnable_alpha
        super().__init__(*args, **kw)

    def _proto(self, num_classes, channels, pt_init, use_feature, margin, scale, t, generator):
        cls = LearnableEuclideanPrototypeLoss if self.learnable_alpha else EuclideanPrototypeLoss
        return cls(num_classes=num_classes, embedding_dim=channels, use_feature=use_feature,
                   generator=generator)


@register("vqnedptunet")
class VQNEDPTUnet(VQPTUnet):
    """``NEDPrototypeLoss`` at the network's ``pt_init`` (k-means unless the
    config says otherwise)."""

    proto_kind = "ned"


class _VQHeadNet(nn.Module):
    """Networks of the ``VQATUnet`` family: a ``VQUnetCore`` with a pre-VQ
    hook, a 3x3 head with bias (no softmax), the x``upsampling``
    align-corners upsample.  ``forward(x, train=False, init_codebook=False,
    generator=None)`` -> (out, commit, usage)."""

    pre_vq: Optional[str] = None

    def __init__(self, encoder_name: str, num_classes: int, vq_cfg,
                 encoder_weights: Optional[str] = None, in_channels: int = 3,
                 decoder_channels: Optional[Sequence[int]] = None, depth: int = 5,
                 upsampling: int = 2, bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None, **core_kw):
        super().__init__()
        self.upsampling = upsampling
        self.core = VQUnetCore(encoder_name, vq_cfg, in_channels, decoder_channels, depth,
                               bn_eps=bn_eps, bn_momentum=bn_momentum, generator=generator,
                               pre_vq=self.pre_vq, **core_kw)
        self.segmentation_head = _vq_head(self.core.decoder_channels[-1], num_classes, generator)

    def forward(self, x, train: bool = False, init_codebook: bool = False,
                generator: Optional[torch.Generator] = None):
        dec, commit, usage = self.core(x, train=train, init_codebook=init_codebook,
                                       generator=generator)
        return _head_out(self.segmentation_head, dec, self.upsampling), commit, usage


@register("vqatunet")
class VQATUnet(_VQHeadNet):
    """``DualAttention`` on every encoder stage before the VQ."""

    pre_vq = "dual_all"


@register("vqcanet")
class VQCANet(_VQHeadNet):
    """``CCA`` on the deepest stage before the VQ (also on a ConvNeXt
    encoder, at depth 4 with ``upsampling`` 4)."""

    pre_vq = "cca_deepest"


@register("drsavqunet")
class DRSAVQUnet(_VQHeadNet):
    """``DRSAM`` on the stages whose VQ passes through."""

    pre_vq = "drsam_identity"


@register("vqimdbnet")
class VQIMDBNet(_VQHeadNet):
    """An ``IMDB`` block on the deepest stage before the VQ."""

    pre_vq = "imdb_deepest"


@register("vqpatchunet")
class VQPatchUNet(_VQHeadNet):
    """A ``ConvMixer`` stem of ``mixer_depth`` blocks in place of the resnet
    conv1/bn1/ReLU."""

    def __init__(self, *args, mixer_depth: int = 3, **kw):
        super().__init__(*args, stem="convmixer", mixer_depth=mixer_depth, **kw)


@register("vqcanetv3")
class VQCANetv3(_VQHeadNet):
    """A ``CCA`` after each decoder block flagged by ``cca``."""

    def __init__(self, *args, cca: Sequence[bool] = (True, True, False, False, False), **kw):
        super().__init__(*args, decoder_cca=tuple(cca), **kw)


class _EncoderNet(nn.Module):
    """``VQCANetv2``/``VQCANetv4``: the encoder, codebooks and decoder at the
    top level (no ``core``)."""

    def __init__(self, encoder_name: str, num_classes: int, vq_cfg, prefix: str,
                 cca: Sequence[bool], encoder_weights: Optional[str] = None,
                 in_channels: int = 3, decoder_channels: Optional[Sequence[int]] = None,
                 depth: int = 5, upsampling: int = 2, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsampling = upsampling
        name = encoder_name if prefix in encoder_name else prefix + encoder_name
        in_encoder_vq = prefix == "ccavq"
        self.encoder, enc_ch = make_encoder(name, in_channels, depth, generator=generator,
                                            cca=tuple(cca),
                                            vq_cfg=vq_cfg if in_encoder_vq else None)
        self.codebooks = (None if in_encoder_vq
                          else make_vq_module(vq_cfg, list(enc_ch), depth, generator))
        self.decoder_channels = _decoder_channels(enc_ch, decoder_channels)
        self.decoder = UnetDecoder(enc_ch, self.decoder_channels, bn_eps, bn_momentum,
                                   generator=generator)
        self.segmentation_head = _vq_head(self.decoder_channels[-1], num_classes, generator)

    def forward(self, x, train: bool = False, init_codebook: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.codebooks is None:
            feats, commit, usage = self.encoder(x, train=train, init_codebook=init_codebook,
                                                generator=generator)
            features = feats[1:]
        else:
            features = list(self.encoder(x)[1:])
            commit, usage = quantize_stages(self.codebooks, features, x, train, init_codebook,
                                            generator)
        dec = self.decoder(features)
        return _head_out(self.segmentation_head, dec, self.upsampling), commit, usage


@register("vqcanetv2")
class VQCANetv2(_EncoderNet):
    """A ``cca`` resnet encoder: per-stage ``CCA`` inside the encoder."""

    def __init__(self, encoder_name: str, num_classes: int, vq_cfg,
                 cca: Sequence[bool] = (False, False, False, True, True), **kw):
        super().__init__(encoder_name, num_classes, vq_cfg, "cca", cca, **kw)


@register("vqcanetv4")
class VQCANetv4(_EncoderNet):
    """A ``ccavq`` resnet encoder, which quantizes its own stage outputs."""

    def __init__(self, encoder_name: str, num_classes: int, vq_cfg,
                 cca: Sequence[bool] = (True, True, False, False, False), **kw):
        super().__init__(encoder_name, num_classes, vq_cfg, "ccavq", cca, **kw)
