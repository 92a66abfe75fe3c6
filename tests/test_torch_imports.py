"""The port stands alone: ``vq_seg_tpu_torch`` (the driver's modules and
CLIs included) and ``chip_smoke.py`` import with JAX and the JAX package
blocked, and no file of theirs imports them.  Importing builds no kernel
and no image decoder."""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "vq_seg_tpu")


def _port_sources():
    return sorted((ROOT / "vq_seg_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_imports_with_jax_blocked():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None  # any import of these now raises
        import vq_seg_tpu_torch
        for m in pkgutil.walk_packages(vq_seg_tpu_torch.__path__, "vq_seg_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        from vq_seg_tpu_torch import Predictor
        from vq_seg_tpu_torch.ops import vq_cuda
        assert vq_cuda._lib is None, "importing must not build or load the kernel"
        # the driver's modules, by name
        for name in ("data", "data.dataset", "data.fastimg", "utils.ckpoints", "utils.logger",
                     "utils.preemption", "utils.seed", "utils.torch_weights", "utils.visualize",
                     "training.cps", "training.variant_drivers", "models.modules.attention",
                     "models.modules.heads", "models.encoders.convnext",
                     "models.networks.vqseghead", "data.augmentations", "losses.focal",
                     "models.networks.deeplabv3", "models.networks.semiweednet",
                     "models.networks.vqvae", "losses.contrastive", "losses.dc",
                     "training.selfsup", "train", "test", "models.encoders.vgg",
                     "models.networks.fcn", "models.networks.ablation", "tools.slic",
                     "tools.obia", "tools.forest", "tools.saliency"):
            assert "vq_seg_tpu_torch." + name in sys.modules, name
        from vq_seg_tpu_torch.data import fastimg
        assert fastimg._lib is None and not fastimg._tried, "importing must not build the decoder"
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, f"{path}:{node.lineno} imports {name}"
