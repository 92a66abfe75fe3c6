"""The port's surface is the JAX package's whole: every network name of the
JAX registry, every ``--mode`` of ``scripts/train.py`` and every encoder
name of the JAX ``make_encoder`` (with the ``cca``/``ccavq`` resnet
prefixes) is accepted by the port, and no file of the port needs sklearn,
skimage or OpenCV, which the JAX package's offline tools import."""
import ast
import pathlib
import re

import pytest
import torch

from vq_seg_tpu.models.encoders import make_encoder as jax_make_encoder
from vq_seg_tpu.models.encoders import resnet_encoders as jax_resnets
from vq_seg_tpu.models.encoders import vgg_encoders as jax_vggs
from vq_seg_tpu.models.encoders.convnext import convnext_encoders as jax_convnexts
from vq_seg_tpu.models.networks import network_dict as jax_network_dict
from vq_seg_tpu_torch import train as train_cli
from vq_seg_tpu_torch.models.encoders import make_encoder
from vq_seg_tpu_torch.models.networks import make_model, network_dict

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_registry():
    from vq_seg_tpu.models.networks import make_model as jax_make_model

    try:  # the JAX registry fills on its first make_model
        jax_make_model({"name": "no_such_network", "params": {}})
    except Exception:
        pass
    return set(jax_network_dict)


def test_registry_holds_every_jax_network():
    with pytest.raises(KeyError):
        make_model({"name": "no_such_network", "params": {}}, device="cpu")
    assert set(network_dict) == _jax_registry()
    assert len(network_dict) == 38


def test_every_mode_is_ported():
    text = (ROOT / "scripts" / "train.py").read_text()
    block = re.search(r'"--mode".*?choices=\[(.*?)\]', text, re.S).group(1)
    jax_modes = re.findall(r'"(\w+)"', block)
    assert train_cli.PORTED == train_cli.MODES
    assert sorted(train_cli.MODES) == sorted(jax_modes) and len(jax_modes) == 13


def _encoder_names():
    """The names the JAX ``make_encoder`` builds (its resnet table also
    lists resnexts, which its ``make_encoder`` refuses)."""
    names = sorted(n for n in jax_resnets if "resnet" in n) + sorted(jax_vggs)
    names += sorted(jax_convnexts)
    names += [f"cca{n}" for n in ("resnet18", "resnet50")]
    names += [f"ccavq{n}" for n in ("resnet18", "resnet50")]
    return names


@pytest.mark.parametrize("name", _encoder_names())
def test_make_encoder_takes_every_jax_name(name):
    depth = 4 if "convnext" in name else 5
    _, jch = jax_make_encoder(name, 3, depth)
    _, ch = make_encoder(name, 3, depth)
    assert tuple(ch) == tuple(jch)


def test_no_port_source_needs_sklearn_skimage_or_opencv():
    for path in sorted((ROOT / "vq_seg_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("sklearn", "skimage", "cv2"), (path, mod)
