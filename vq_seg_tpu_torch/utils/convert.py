"""Carry a JAX-package variable tree of a ported network across to the
port's ``state_dict``.

The tree comes as nested dicts of numpy arrays (the caller does
``jax.tree_util.tree_map(np.asarray, variables)``); nothing here imports JAX.

  * conv kernels HWIO -> OIHW;
  * BN ``params/.../{scale,bias}`` + ``batch_stats/.../{mean,var}`` ->
    ``weight/bias/running_mean/running_var``;
  * encoder modules keep their torchvision names (``downsample_0`` ->
    ``downsample.0``); decoder BNs sit at
    ``block{i}/ConvBNReLU_{j}/BatchNorm_0/BatchNorm_0``;
  * the head is ``params/segmentation_head/Conv_0`` (the prototype
    networks' 1x1 or 3x3 conv), ``params/segmentation_head/conv/Conv_0``
    (the ``_VQHead`` of ``unet`` and ``vqunet_v2``) or
    ``params/segmentation_head_{0,1}/Conv_0`` (the two-layer head of
    ``vqreptunetdouble1x1``, the port's ``segmentation_head.{0,1}``); the
    angular heads of ``vqashunet(v2)`` hold ``ConvPad_0`` and their class
    ``embedding`` (the port's ``segmentation_head.{conv,embedding}``);
  * codebooks ``codebook/core/VectorQuantizer_{n}/embedding`` (with
    ``cluster_size`` and ``embed_avg`` under ``vq_cfg.ema``) are numbered
    over the VQ stages only, so ``num_embeddings`` (the model's
    ``vq_cfg.num_embeddings``; None or all zeros for ``unet``) says which
    stage each one belongs to;
  * the prototype table ``params/prototype_loss/embedding`` is
    ``prototype_loss.embedding``, with as many rows as it has (K-1 for
    ``vqonlyptunet1x1``), and the learnable scalar of ``vqeuptunet``'s
    loss ``params/prototype_loss/alpha`` is ``prototype_loss.alpha``.  A tree from ``init`` without ``gt`` has none;
    the port's prototype module then keeps its drawn table on a strict
    load (the training init phase overwrites it);
  * the attention networks' trees: ``core/att_{i}`` (``DualAttention``),
    ``core/cca``, ``core/imdb``, ``core/drsam_{i}``, ``core/mixer_stem``
    (the port's ``core.encoder.custom_stem``), the encoder's ``cca_{i}``,
    ``decoder/cca{i}``, the top-level ``encoder``/``decoder``/codebooks of
    ``vqcanetv2``, the auto-named ``CCAVQResNetEncoder_0`` of
    ``vqcanetv4`` (the port's ``encoder``, with ``backbone`` and in-encoder
    ``codebooks``), a ConvNeXt encoder (LayerNorm ``scale`` -> ``weight``,
    ``Dense`` kernels (in, out) -> ``Linear`` (out, in), ``gamma``) and the
    ``codebook/segmentation_head/embedding`` of ``vqsegheadnet``.
    flax's auto-names (``ConvPad_{k}``, ``Dense_{k}``...) become the port's
    attribute names, module by module;
  * the DeepLab trees (top-level ``encoder``; ``ASPP_0`` and
    ``ConvBNReLU_0`` of ``deeplabv3``; the ``decoder`` of ``deeplabv3plus``
    and ``semiweednet`` with its ``ASPP_0``, ``SeparableConvBNReLU_{0,1}``
    and 48-channel ``ConvBNReLU_0``; ``semiweednet``'s ``ska`` and
    ``mlp_{0,1}`` ``Dense`` layers), whose ``SegmentationHead`` is
    ``segmentation_head/ConvPad_0`` (the port's ``segmentation_head.conv``);
    the angular v3 head (``ConvPad_0`` and ``embedding``, as v2's);
  * the VQ-VAE trees: top-level ``encoder``, codebooks
    ``codebook/VectorQuantizer_{n}`` (``vqvaev2``) or ``codebook/codebook``
    (``vqvaev1``), and the ``decoder``'s ``ConvPad_0``, ``ResBlock_{i}``
    and ``ConvTranspose_{j}``, whose (kh, kw, in, out) kernel becomes
    ``ConvTranspose2d``'s (in, out, kh, kw) flipped in both spatial axes;
  * ``fcn32s``: a VGG ``encoder`` whose ``features_{N}`` are the port's
    ``encoder.features.{N}``, the ``fc6``/``fc7``/``score`` convs and the
    ``upscore`` transposed conv (no bias); its ``upscore_kernel``, which
    the JAX forward never reads, has no counterpart;
  * ``unetoriginal``: ``contract{i}``, ``bottleneck`` and ``expand{i}``
    (two ``ConvBNReLU`` each, the port's ``contract.{i}.{j}``...) and the
    ``upconv{i}`` transposed convs (``upconv.{i}``);
  * ``VQUnetwithSalientloss``: beside its ``core`` and head, the saliency
    decoder's auto-named ``ConvBNReLU_{0..3}`` and ``ConvPad_0`` (the
    port's ``salient_decoder.{i}`` and ``salient_out``).

``cps_state_from_flax`` loads both models of a JAX ``CPSTrainState`` into a
port ``CPSTrainState``; ``sup_state_from_flax`` the one model of a JAX
supervised ``TrainState`` into the port's (``training/supervised.py``).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))  # a copy: the input may be read-only


def _conv(sd: dict, name: str, p: Mapping):
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd: dict, name: str, p: Mapping, s: Mapping):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _linear(sd: dict, name: str, p: Mapping):
    """flax ``Dense`` (in, out) -> torch ``Linear`` (out, in)."""
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def _layer_norm(sd: dict, name: str, p: Mapping):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _cbr(sd: dict, name: str, p: Mapping, s: Mapping):
    """``ConvBNReLU`` (its BN is a ``BatchNorm`` wrapping flax's)."""
    _conv(sd, f"{name}.conv", p["ConvPad_0"]["Conv_0"])
    _bn(sd, f"{name}.bn", p["BatchNorm_0"]["BatchNorm_0"], s["BatchNorm_0"]["BatchNorm_0"])


def _contrast(sd: dict, name: str, p: Mapping):
    _conv(sd, f"{name}.fc1", p["ConvPad_0"]["Conv_0"])
    _conv(sd, f"{name}.fc2", p["ConvPad_1"]["Conv_0"])


def _sep(sd: dict, name: str, p: Mapping, s: Mapping):
    """``SeparableConvBNReLU``: depthwise ``ConvPad_0``, pointwise
    ``ConvPad_1``, a flax ``BatchNorm_0``."""
    _conv(sd, f"{name}.depthwise", p["ConvPad_0"]["Conv_0"])
    _conv(sd, f"{name}.pointwise", p["ConvPad_1"]["Conv_0"])
    _bn(sd, f"{name}.bn", p["BatchNorm_0"], s["BatchNorm_0"])


def _aspp(sd: dict, name: str, p: Mapping, s: Mapping):
    """``ASPP``: ``ConvBNReLU_0`` (the 1x1 branch), then per rate a
    ``SeparableConvBNReLU_{i}`` (separable) or a ``ConvBNReLU_{i + 1}``,
    then the pooled branch and the projection, the last two
    ``ConvBNReLU``s."""
    cbrs = sorted((k for k in p if k.startswith("ConvBNReLU_")), key=lambda k: int(k[11:]))
    seps = sorted((k for k in p if k.startswith("SeparableConvBNReLU_")),
                  key=lambda k: int(k[20:]))
    _cbr(sd, f"{name}.b0", p[cbrs[0]], s[cbrs[0]])
    for i, key in enumerate(seps or cbrs[1:-2]):
        (_sep if seps else _cbr)(sd, f"{name}.rates.{i}", p[key], s[key])
    _cbr(sd, f"{name}.pool", p[cbrs[-2]], s[cbrs[-2]])
    _cbr(sd, f"{name}.project", p[cbrs[-1]], s[cbrs[-1]])


def _deeplab_decoder(sd: dict, name: str, p: Mapping, s: Mapping):
    _aspp(sd, f"{name}.aspp", p["ASPP_0"], s["ASPP_0"])
    _sep(sd, f"{name}.aspp_sep", p["SeparableConvBNReLU_0"], s["SeparableConvBNReLU_0"])
    _cbr(sd, f"{name}.block1", p["ConvBNReLU_0"], s["ConvBNReLU_0"])
    _sep(sd, f"{name}.block2", p["SeparableConvBNReLU_1"], s["SeparableConvBNReLU_1"])


def _conv_transpose(sd: dict, name: str, p: Mapping):
    """flax ``ConvTranspose`` (kh, kw, in, out), not flipped -> torch
    ``ConvTranspose2d`` (in, out, kh, kw), flipped."""
    k = np.asarray(p["kernel"])[::-1, ::-1]
    sd[f"{name}.weight"] = _t(np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _vqvae_decoder(sd: dict, name: str, p: Mapping, s: Mapping):
    _conv(sd, f"{name}.conv_in", p["ConvPad_0"]["Conv_0"])
    for i in range(sum(k.startswith("ResBlock_") for k in p)):
        block = p[f"ResBlock_{i}"]
        _conv(sd, f"{name}.resblocks.{i}.conv1", block["ConvPad_0"]["Conv_0"])
        _conv(sd, f"{name}.resblocks.{i}.conv2", block["ConvPad_1"]["Conv_0"])
    for j in range(sum(k.startswith("ConvTranspose_") for k in p)):
        _conv_transpose(sd, f"{name}.up.{j}", p[f"ConvTranspose_{j}"])


def _ska(sd: dict, name: str, p: Mapping, s: Mapping):
    """``SKA``: one ``ConvBNReLU`` per branch, the squeeze ``ConvBNReLU``
    (the last) and the ``ConvPad_0`` select."""
    branches = sum(k.startswith("ConvBNReLU_") for k in p) - 1
    for i in range(branches):
        _cbr(sd, f"{name}.branches.{i}", p[f"ConvBNReLU_{i}"], s[f"ConvBNReLU_{i}"])
    _cbr(sd, f"{name}.squeeze", p[f"ConvBNReLU_{branches}"], s[f"ConvBNReLU_{branches}"])
    _conv(sd, f"{name}.select", p["ConvPad_0"]["Conv_0"])


def _cca(sd: dict, name: str, p: Mapping, s: Mapping):
    _contrast(sd, f"{name}.contrast", p["ContrastAttention_0"])
    _cbr(sd, f"{name}.dw", p["ConvBNReLU_0"], s["ConvBNReLU_0"])
    _cbr(sd, f"{name}.pw", p["ConvBNReLU_1"], s["ConvBNReLU_1"])


def _dual(sd: dict, name: str, p: Mapping, s: Mapping):
    pam = p["PAM_0"]
    for i, part in enumerate(("query", "key", "value")):
        _conv(sd, f"{name}.pam.{part}", pam[f"ConvPad_{i}"]["Conv_0"])
    sd[f"{name}.pam.gamma"] = _t(pam["gamma"])
    sd[f"{name}.cam.gamma"] = _t(p["CAM_0"]["gamma"])


def _drsam(sd: dict, name: str, p: Mapping, s: Mapping):
    branches = sum(k.startswith("ConvBNReLU_") for k in p)
    for i in range(branches):
        _cbr(sd, f"{name}.convs.{i}", p[f"ConvBNReLU_{i}"], s[f"ConvBNReLU_{i}"])
        _linear(sd, f"{name}.fc1.{i}", p[f"Dense_{2 * i}"])
        _linear(sd, f"{name}.fc2.{i}", p[f"Dense_{2 * i + 1}"])
    _conv(sd, f"{name}.fuse", p["ConvPad_0"]["Conv_0"])


def _imdb(sd: dict, name: str, p: Mapping, s: Mapping):
    last = sum(k.startswith("ConvPad_") for k in p) - 1  # the 1x1 fuse comes last
    for i in range(last):
        _conv(sd, f"{name}.convs.{i}", p[f"ConvPad_{i}"]["Conv_0"])
    _conv(sd, f"{name}.fuse", p[f"ConvPad_{last}"]["Conv_0"])
    _contrast(sd, f"{name}.contrast", p["ContrastAttention_0"])


def _mixer(sd: dict, name: str, p: Mapping, s: Mapping):
    """``ConvMixer``: ConvPad_0/BatchNorm_0 embed, then per block a
    depthwise and a pointwise ConvPad, each with its BatchNorm."""
    _conv(sd, f"{name}.embed", p["ConvPad_0"]["Conv_0"])
    _bn(sd, f"{name}.embed_bn", p["BatchNorm_0"], s["BatchNorm_0"])
    for d in range((sum(k.startswith("ConvPad_") for k in p) - 1) // 2):
        for j, part in ((1, "dw"), (2, "pw")):
            k = 2 * d + j
            _conv(sd, f"{name}.{part}.{d}", p[f"ConvPad_{k}"]["Conv_0"])
            _bn(sd, f"{name}.{part}_bn.{d}", p[f"BatchNorm_{k}"], s[f"BatchNorm_{k}"])


def _convnext_block(sd: dict, name: str, p: Mapping):
    _conv(sd, f"{name}.dwconv", p["dwconv"]["Conv_0"])
    _layer_norm(sd, f"{name}.norm", p["norm"])
    _linear(sd, f"{name}.pwconv1", p["pwconv1"])
    _linear(sd, f"{name}.pwconv2", p["pwconv2"])
    sd[f"{name}.gamma"] = _t(p["gamma"])


def _encoder(sd: dict, prefix: str, p: Mapping, s: Mapping):
    """Encoder subtree -> ``{prefix}conv1.weight``, ``{prefix}layer1.0.bn1.*``,
    ``{prefix}cca_{i}.*`` (a resnet), ``{prefix}stem_conv.*``,
    ``{prefix}stage0_block0.*`` (a ConvNeXt)..."""
    for key, sub in p.items():
        flat = key.replace("downsample_", "downsample.").replace("features_", "features.")
        name = f"{prefix}{flat}"
        if key.startswith("cca_"):
            _cca(sd, name, sub, s[key])
        elif key.startswith("stage"):
            _convnext_block(sd, name, sub)
        elif "Conv_0" in sub:  # a ConvPad
            _conv(sd, name, sub["Conv_0"])
        elif "scale" in sub:  # a BatchNorm, or a ConvNeXt LayerNorm (no statistics)
            if key in s:
                _bn(sd, name, sub, s[key])
            else:
                _layer_norm(sd, name, sub)
        else:  # a layer or a block
            _encoder(sd, f"{name}.", sub, s[key])


def _decoder(sd: dict, prefix: str, dp: Mapping, ds: Mapping):
    for block, bp in dp.items():
        if block.startswith("cca"):  # CCAUnetDecoder
            _cca(sd, f"{prefix}{block}", bp, ds[block])
            continue
        i = int(block[len("block"):])
        for cbr, cp in bp.items():
            j = int(cbr.rsplit("_", 1)[1])
            _cbr(sd, f"{prefix}blocks.{i}.{j}", cp, ds[block][cbr])


def _codebooks(sd: dict, prefix: str, tree: Mapping, num_embeddings):
    """``VectorQuantizer_{n}/{embedding, cluster_size, embed_avg}`` of
    ``tree``, numbered over the VQ stages only -> ``{prefix}{stage}.*``."""
    found = [k for k in tree if k.startswith("VectorQuantizer_")]
    stages = [i for i, k in enumerate(num_embeddings or ()) if k > 0]
    if len(found) != len(stages):
        raise ValueError(f"{len(found)} codebooks in the tree, but num_embeddings "
                         f"{list(num_embeddings)} has {len(stages)} VQ stages")
    for n, stage in enumerate(stages):
        _vq(sd, f"{prefix}{stage}", tree[f"VectorQuantizer_{n}"])


def _vq(sd: dict, name: str, p: Mapping):
    """One codebook: its ``embedding`` and, under ``vq_cfg.ema``, its
    ``cluster_size`` and ``embed_avg``."""
    for key in ("embedding", "cluster_size", "embed_avg"):
        if key in p:
            sd[f"{name}.{key}"] = _t(p[key])


# the children of the JAX package's VQUnetCore other than encoder and
# decoder: (name prefix, converter, port name)
_CORE_HOOKS = (("att_", _dual, None), ("cca", _cca, None), ("imdb", _imdb, None),
               ("drsam_", _drsam, None), ("mixer_stem", _mixer, "encoder.custom_stem"))


def _top_level(sd: dict, params: Mapping, stats: Mapping, codebooks: Mapping,
                num_embeddings):
    """The children of a network without a ``core``: ``vqcanetv2``
    (encoder, codebooks, U-Net decoder), ``vqcanetv4`` (its auto-named
    ccavq encoder), the DeepLab networks and the VQ-VAEs.  The head is
    mapped by the caller."""
    for key, sub in params.items():
        st = stats.get(key, {})
        if key == "encoder":
            _encoder(sd, "encoder.", sub, st)
        elif key == "CCAVQResNetEncoder_0":
            _encoder(sd, "encoder.backbone.", sub["backbone"], st["backbone"])
            _codebooks(sd, "encoder.codebooks.", codebooks.get(key, {}), num_embeddings)
        elif key == "decoder":
            if "ASPP_0" in sub:
                _deeplab_decoder(sd, "decoder", sub, st)
            elif "ConvPad_0" in sub:
                _vqvae_decoder(sd, "decoder", sub, st)
            else:
                _decoder(sd, "decoder.", sub, st)
        elif key == "ASPP_0":  # deeplabv3
            _aspp(sd, "aspp", sub, st)
        elif key == "ConvBNReLU_0":  # deeplabv3
            _cbr(sd, "conv", sub, st)
        elif key == "ska":
            _ska(sd, "ska", sub, st)
        elif key in ("mlp_0", "mlp_1"):
            _linear(sd, key, sub)
        elif key in ("fc6", "fc7", "score"):  # fcn32s
            _conv(sd, key, sub["Conv_0"])
        elif key == "upscore" or key.startswith("upconv"):  # fcn32s, unetoriginal
            _conv_transpose(sd, key.replace("upconv", "upconv."), sub)
        elif key.startswith(("contract", "expand")) or key == "bottleneck":  # unetoriginal
            name = key if key == "bottleneck" else f"{key.rstrip('0123456789')}.{key[-1]}"
            for j in range(2):
                _cbr(sd, f"{name}.{j}", sub[f"ConvBNReLU_{j}"], st[f"ConvBNReLU_{j}"])
        elif key not in ("segmentation_head", "prototype_loss", "upscore_kernel"):
            raise ValueError(f"no mapping for params/{key}")
    if "encoder" in params:
        if "codebook" in codebooks:  # vqvaev1's one codebook
            _vq(sd, "codebook", codebooks["codebook"])
        else:  # none for the DeepLab networks (num_embeddings None)
            _codebooks(sd, "codebooks.", codebooks, num_embeddings)


def state_dict_from_flax(variables: Mapping,
                         num_embeddings: Optional[Sequence[int]] = (0, 0, 512, 512, 512)) -> dict:
    """Variables of a ported network -> the port's state_dict.  A subtree
    that nothing maps raises, so a load stays strict."""
    sd: dict = {}
    params, stats = variables["params"], variables.get("batch_stats", {})
    codebooks = variables.get("codebook", {})
    if "core" in params:
        cp, cs = params["core"], stats.get("core", {})
        for key, sub in cp.items():
            if key == "encoder":
                _encoder(sd, "core.encoder.", sub, cs.get("encoder", {}))
            elif key == "decoder":
                _decoder(sd, "core.decoder.", sub, cs["decoder"])
            else:
                hook = next((h for h in _CORE_HOOKS if key.startswith(h[0])), None)
                if hook is None:
                    raise ValueError(f"no mapping for params/core/{key}")
                hook[1](sd, f"core.{hook[2] or key}", sub, cs.get(key, {}))
        _codebooks(sd, "core.codebooks.", codebooks.get("core", {}), num_embeddings)
        for key, sub in params.items():  # VQUnetwithSalientloss's saliency decoder
            if key.startswith("ConvBNReLU_"):
                _cbr(sd, f"salient_decoder.{key[11:]}", sub, stats[key])
            elif key == "ConvPad_0":
                _conv(sd, "salient_out", sub["Conv_0"])
    else:  # networks without a core: their children at the top level
        _top_level(sd, params, stats, codebooks, num_embeddings)

    if "segmentation_head_0" in params:
        for i in range(2):
            _conv(sd, f"segmentation_head.{i}", params[f"segmentation_head_{i}"]["Conv_0"])
    elif "segmentation_head" in params:
        head = params["segmentation_head"]
        if "ConvPad_0" in head:  # an angular head, or a SegmentationHead
            _conv(sd, "segmentation_head.conv", head["ConvPad_0"]["Conv_0"])
            if "embedding" in head:
                sd["segmentation_head.embedding"] = _t(head["embedding"])
        else:
            _conv(sd, "segmentation_head",
                  head["conv"]["Conv_0"] if "conv" in head else head["Conv_0"])
    if "segmentation_head" in codebooks:  # VQSegHeadNet's codebook classifier
        sd["segmentation_head.embedding"] = _t(codebooks["segmentation_head"]["embedding"])
    for name, value in params.get("prototype_loss", {}).items():  # embedding, alpha
        sd[f"prototype_loss.{name}"] = _t(value)
    return sd


def cps_state_from_flax(state, state_numpy, num_embeddings: Sequence[int] = (0, 0, 512, 512, 512)):
    """Fill ``state.model_1``/``model_2`` (a port ``CPSTrainState``) from a
    JAX ``CPSTrainState`` whose leaves are numpy arrays, strictly, and take
    its step count.  Optimizer moments are not carried: the port's
    optimizers keep their own state.  Returns ``state``."""
    for model, variables in ((state.model_1, state_numpy.variables_1),
                             (state.model_2, state_numpy.variables_2)):
        model.load_state_dict(state_dict_from_flax(variables, num_embeddings))
    state.step = int(np.asarray(state_numpy.step))
    return state


def sup_state_from_flax(state, state_numpy,
                        num_embeddings: Optional[Sequence[int]] = (0, 0, 512, 512, 512)):
    """Fill ``state.model`` (the port's supervised ``TrainState``) from a JAX
    supervised ``TrainState`` whose leaves are numpy arrays, strictly, and
    take its step count.  Optimizer moments are not carried.  Returns
    ``state``."""
    state.model.load_state_dict(state_dict_from_flax(state_numpy.variables, num_embeddings))
    state.step = int(np.asarray(state_numpy.step))
    return state
