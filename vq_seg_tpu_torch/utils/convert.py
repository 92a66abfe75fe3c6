"""Carry a JAX-package variable tree of the flagship network across to the
port's ``state_dict``.

The tree comes as nested dicts of numpy arrays (the caller does
``jax.tree_util.tree_map(np.asarray, variables)``); nothing here imports JAX.

  * conv kernels HWIO -> OIHW;
  * BN ``params/.../{scale,bias}`` + ``batch_stats/.../{mean,var}`` ->
    ``weight/bias/running_mean/running_var``;
  * encoder modules keep their torchvision names (``downsample_0`` ->
    ``downsample.0``); decoder BNs sit at
    ``block{i}/ConvBNReLU_{j}/BatchNorm_0/BatchNorm_0``;
  * the head is ``params/segmentation_head/Conv_0/kernel``;
  * codebooks ``codebook/core/VectorQuantizer_{n}/embedding`` are numbered
    over the VQ stages only, so ``num_embeddings`` (the model's
    ``vq_cfg.num_embeddings``) says which stage each one belongs to.

A missing ``prototype_loss`` is fine: ``init`` without ``gt`` creates none,
and the port's eval network has none.
"""
from __future__ import annotations

from typing import Mapping, Sequence

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


def _encoder(sd: dict, prefix: str, p: Mapping, s: Mapping):
    """Encoder subtree -> ``{prefix}conv1.weight``, ``{prefix}layer1.0.bn1.*``..."""
    for key, sub in p.items():
        name = f"{prefix}{key.replace('downsample_', 'downsample.')}"
        if "Conv_0" in sub:  # a ConvPad
            _conv(sd, name, sub["Conv_0"])
        elif "scale" in sub:  # a BatchNorm
            _bn(sd, name, sub, s[key])
        else:  # a layer or a block
            _encoder(sd, f"{name}.", sub, s[key])


def state_dict_from_flax(variables: Mapping,
                         num_embeddings: Sequence[int] = (0, 0, 512, 512, 512)) -> dict:
    """Flagship ``VQRePTUnet1x1v2`` variables -> the port's state_dict."""
    sd: dict = {}
    params, stats = variables["params"], variables["batch_stats"]
    _encoder(sd, "core.encoder.", params["core"]["encoder"], stats["core"]["encoder"])

    dp, ds = params["core"]["decoder"], stats["core"]["decoder"]
    for block, bp in dp.items():
        i = int(block[len("block"):])
        for cbr, cp in bp.items():
            j = int(cbr.rsplit("_", 1)[1])
            name = f"core.decoder.blocks.{i}.{j}"
            _conv(sd, f"{name}.conv", cp["ConvPad_0"]["Conv_0"])
            _bn(sd, f"{name}.bn", cp["BatchNorm_0"]["BatchNorm_0"],
                ds[block][cbr]["BatchNorm_0"]["BatchNorm_0"])

    _conv(sd, "segmentation_head", params["segmentation_head"]["Conv_0"])

    codebooks = variables.get("codebook", {}).get("core", {})
    stages = [i for i, k in enumerate(num_embeddings) if k > 0]
    if len(codebooks) != len(stages):
        raise ValueError(f"{len(codebooks)} codebooks in the tree, but num_embeddings "
                         f"{list(num_embeddings)} has {len(stages)} VQ stages")
    for n, stage in enumerate(stages):
        sd[f"core.codebooks.{stage}.embedding"] = _t(codebooks[f"VectorQuantizer_{n}"]["embedding"])
    return sd
