"""Pretrained encoder weights, counterpart of the ResNet, VGG and ConvNeXt
parts of the JAX package's ``utils/torch_weights.py``.

The reference fetches ``PRETRAINED_URLS[name][tag]`` through model_zoo
(models/encoders/__init__.py:24-29).  Nothing is fetched here: a tag is
resolved against files the user placed in ``$VQ_SEG_PRETRAINED_DIR`` (or
``~/.cache/vq_seg_tpu/pretrained``) under the same names the JAX package
looks for, so one set of files serves both packages; a path is used as it
is.  When nothing resolves, a loud warning says so and the encoder keeps
its drawn weights.

The port's ``ResNetEncoder`` keeps torchvision's module names, and
``ConvPad`` is an ``nn.Conv2d`` itself (no nested submodule), so a
torchvision ResNet state dict maps onto it key for key: ``fc.*`` and
``num_batches_tracked`` are dropped, and the BN running statistics load
with the weights.  A torchvision ConvNeXt state dict is renamed onto the
port's ``ConvNeXtEncoder`` by ``convert_convnext``.  The port's
``VGGEncoder`` keeps torchvision's ``features.N`` indices, so a torchvision
VGG state dict loads key for key (``classifier.*`` dropped, and with it the
stages the encoder's depth leaves out).
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

import torch
import torch.nn as nn

PRETRAINED_DIR_ENV = "VQ_SEG_PRETRAINED_DIR"
DEFAULT_PRETRAINED_DIR = os.path.expanduser("~/.cache/vq_seg_tpu/pretrained")

_FB = "https://dl.fbaipublicfiles.com/semiweaksupervision/model_files/"
PRETRAINED_URLS = {
    "resnet18": {
        "imagenet": "https://download.pytorch.org/models/resnet18-5c106cde.pth",
        "imagenet_ssl": _FB + "semi_supervised_resnet18-d92f0530.pth",
        "imagenet_swsl": _FB + "semi_weakly_supervised_resnet18-118f1556.pth",
    },
    "resnet50": {
        "imagenet": "https://download.pytorch.org/models/resnet50-19c8e357.pth",
        "imagenet_ssl": _FB + "semi_supervised_resnet50-08389792.pth",
        "imagenet_swsl": _FB + "semi_weakly_supervised_resnet50-16a12f1b.pth",
    },
    "convnext_tiny": {"imagenet": "https://download.pytorch.org/models/convnext_tiny-983f1562.pth"},
    "convnext_small": {"imagenet": "https://download.pytorch.org/models/convnext_small-0c510722.pth"},
    "convnext_base": {"imagenet": "https://download.pytorch.org/models/convnext_base-6075fbad.pth"},
    "convnext_large": {"imagenet": "https://download.pytorch.org/models/convnext_large-ea097f82.pth"},
}
_RESNET_KEYS = ("conv1", "bn1", "layer1", "layer2", "layer3", "layer4")


def resolve_pretrained(encoder_weights: Optional[str], encoder_name: str) -> Optional[str]:
    """``cfg.model.params.encoder_weights`` -> a local .pth file, or None.

    A path is returned as it is.  A tag ("imagenet", "imagenet_ssl",
    "imagenet_swsl") is looked up as ``{encoder_name}-{tag}.pth``,
    ``{tag}-{encoder_name}.pth``, ``{encoder_name}_{tag}.pth`` and the URL's
    file name under $VQ_SEG_PRETRAINED_DIR or ~/.cache/vq_seg_tpu/pretrained.
    When nothing resolves it warns, loudly, and returns None."""
    if not encoder_weights or str(encoder_weights).lower() in ("none", "false"):
        return None
    if os.path.isfile(str(encoder_weights)):
        return str(encoder_weights)
    cache_dir = os.environ.get(PRETRAINED_DIR_ENV, DEFAULT_PRETRAINED_DIR)
    candidates = [f"{encoder_name}-{encoder_weights}.pth",
                  f"{encoder_weights}-{encoder_name}.pth",
                  f"{encoder_name}_{encoder_weights}.pth"]
    url = PRETRAINED_URLS.get(encoder_name, {}).get(str(encoder_weights))
    if url:
        candidates.append(url.rsplit("/", 1)[-1])
    for c in candidates:
        path = os.path.join(cache_dir, c)
        if os.path.isfile(path):
            return path
    warnings.warn(
        f"encoder_weights='{encoder_weights}' for '{encoder_name}' could not be "
        f"resolved: not a file, and none of {candidates} exist in {cache_dir} "
        f"(set ${PRETRAINED_DIR_ENV} or pass a .pth path). Training proceeds "
        f"FROM SCRATCH — the reference would have loaded pretrained weights"
        + (f" from {url}" if url else "") + ".",
        stacklevel=2)
    return None


def convert_convnext(state_dict) -> dict:
    """torchvision ConvNeXt state dict -> the port's ``ConvNeXtEncoder``
    keys.  torchvision: ``features.0.{0,1}`` the stem conv and LayerNorm;
    stages at features 1/3/5/7 (a block is ``block.0`` the depthwise conv,
    ``block.2`` the LayerNorm, ``block.3``/``block.5`` the Linears, and
    ``layer_scale`` (dim, 1, 1)); downsamplers at 2/4/6 (``.0`` LayerNorm,
    ``.1`` the 2x2 conv).  ``classifier.*`` is dropped.  Linears stay (out,
    in) and convs OIHW: both sides are torch."""
    out = {}
    sub = {"0": "dwconv", "2": "norm", "3": "pwconv1", "5": "pwconv2"}
    for key, v in state_dict.items():
        parts = key.split(".")
        if parts[0] != "features":
            continue
        fi = int(parts[1])
        if fi == 0:
            out[f"{'stem_conv' if parts[2] == '0' else 'stem_norm'}.{parts[3]}"] = v
        elif fi % 2 == 0:
            k = fi // 2
            out[f"{'down_norm' if parts[2] == '0' else 'down_conv'}{k}.{parts[3]}"] = v
        else:
            mod = f"stage{fi // 2}_block{parts[2]}"
            if parts[3] == "layer_scale":
                out[f"{mod}.gamma"] = v.reshape(-1)
            else:
                out[f"{mod}.{sub[parts[4]]}.{parts[5]}"] = v
    return out


def pretrained_encoder(model: nn.Module) -> nn.Module:
    """The module a pretrained file loads into: ``core.encoder``, the
    top-level ``encoder`` (``vqcanetv2``, the DeepLab networks, ``fcn32s``)
    or its ``backbone`` (the ccavq encoder of ``vqcanetv4``)."""
    encoder = model.core.encoder if hasattr(model, "core") else model.encoder
    return getattr(encoder, "backbone", encoder)


def load_encoder_weights(encoder: nn.Module, pth_path: str):
    """Load a torchvision-layout ResNet, VGG or ConvNeXt state dict (``.pth``)
    into ``encoder`` in place: weights, BN affine parameters and BN running
    statistics.  Keys the encoder does not have (``fc.*``, stages beyond its
    depth) are dropped, as is ``num_batches_tracked``; a key of the
    pretrained network that the encoder has and the file lacks raises.  The
    modules that the pretrained network lacks (a ResNet's ``cca_{i}``, a
    ``custom_stem``) keep their drawn weights."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    convnext = any(".block." in k and k.startswith("features.") for k in sd)
    vgg = not convnext and any(k.startswith("features.") for k in sd)
    if convnext:
        sd = convert_convnext(sd)
    own = encoder.state_dict()
    new = {k: v for k, v in sd.items() if k in own and not k.endswith("num_batches_tracked")}
    covered = own if convnext or vgg else [k for k in own if k.split(".")[0] in _RESNET_KEYS]
    missing = [k for k in covered if k not in new and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"{pth_path} lacks {len(missing)} encoder keys, e.g. {missing[:3]}")
    encoder.load_state_dict(new, strict=False)
