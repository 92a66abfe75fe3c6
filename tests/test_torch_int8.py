"""Port parity: weight-only int8 serving (``Predictor(quant="int8")``)
against the JAX package's ``_quantize_params_int8``, on the CPU at
resnet18 / K=8 / 64x64.

  * Per network (the flagship, ``semiweednet``'s dense layers, ``vqvaev2``'s
    transposed convs, ``vqashunetv2``'s class table), from seeded weights:
    the same set of tensors quantized; every int8 value and every scale
    bitwise JAX's after the layout map of ``utils/convert.py`` (which fixes
    each tensor's output axis); the 1-D parameters bitwise JAX's bf16; the
    dequantised bf16 weights bitwise JAX's.
  * The flagship's int8 predictor: labels agree with its own f32 predictor
    and with JAX's int8 predictor on at least 0.8 of the pixels (the rule of
    ``tests/test_serving.py``); the caller's model is left as it was; the
    quantized parameters take at most 0.55 of the bf16 model's bytes; and
    ``from_checkpoint(quant="int8")`` serves the same labels.
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.serving import Predictor as JaxPredictor
from vq_seg_tpu.serving import _dequantize_params, _quantize_params_int8
from _port_helpers import to_np
from _seeded_flax import seeded_variables
from test_torch_model import HW, MODEL_CFG, build_flagship
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.serving import Predictor, _Int8Weights
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax

torch.set_num_threads(1)

NUM_EMB = [0, 0, 8, 8, 8]
VQ = {"num_embeddings": NUM_EMB, "kmeans_init": True}
# name -> (params, the init's arguments after x: with gt where a prototype
# or class table is made only then)
NETWORKS = {
    "vqreptunet1x1v2": ({"encoder_name": "resnet18", "num_classes": 3, "vq_cfg": VQ},
                        ("gt", 0.7)),
    "semiweednet": ({"encoder_name": "resnet18", "num_classes": 3}, ()),
    "vqvaev2": ({"encoder_name": "resnet18", "vq_cfg": VQ}, ()),
    "vqashunetv2": ({"encoder_name": "resnet18", "num_classes": 3, "vq_cfg": VQ,
                     "margin": 1.57, "scale": 30.0}, ("gt",)),
}


def _mapped(v, params, num_emb):
    """A params-shaped tree through the layout map: name -> tensor."""
    return state_dict_from_flax({**v, "params": params}, num_emb)


@pytest.mark.parametrize("name", list(NETWORKS))
def test_int8_values_and_scales_match_jax(name):
    params, extra = NETWORKS[name]
    cfg = {"name": name, "params": params}
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, HW, HW, 3)).astype(np.float32)
    gt = jnp.asarray(rng.integers(0, 3, size=(2, HW, HW)))
    jmodel = jax_make_model(cfg)
    args = (jnp.asarray(x),) + tuple(gt if a == "gt" else a for a in extra)
    v = to_np(seeded_variables(jmodel, args, train=True))
    num_emb = NUM_EMB if "vq_cfg" in cfg["params"] else None
    model = make_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(v, num_emb))
    jq, scales = _quantize_params_int8(v)
    leaves, treedef = jax.tree_util.tree_flatten(v["params"])
    unflat = lambda xs: jax.tree_util.tree_unflatten(treedef, xs)
    # scales of the unquantized leaves and the quantized-or-not mask, as
    # params-shaped trees so that the layout map carries them
    mask = _mapped(v, unflat([np.full(a.shape, float(s is not None), np.float32)
                              for a, s in zip(leaves, scales)]), num_emb)
    scale = _mapped(v, unflat([np.broadcast_to(np.asarray(s), a.shape).copy() if s is not None
                               else np.zeros(a.shape, np.float32)
                               for a, s in zip(leaves, scales)]), num_emb)
    q = _mapped(v, jax.tree_util.tree_map(np.asarray, jq["params"]), num_emb)
    deq = _mapped(v, jax.tree_util.tree_map(
        np.asarray, _dequantize_params(jq["params"], scales)), num_emb)

    weights = _Int8Weights(model, torch.device("cpu"))
    params = dict(model.named_parameters())
    want_quantized = {n for n in params if mask[n].flatten()[0] == 1.0}
    assert set(weights.quantized) == want_quantized
    assert set(weights.vectors) == set(params) - want_quantized
    assert want_quantized == {n for n, p in params.items() if p.dim() >= 2}
    deq_port = weights.params()
    for n, (qq, s, _) in weights.quantized.items():
        assert qq.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(qq.numpy().astype(np.float32), q[n].numpy(), err_msg=n)
        np.testing.assert_array_equal(s.expand_as(qq).numpy(), scale[n].numpy(), err_msg=n)
        np.testing.assert_array_equal(deq_port[n].float().numpy(), deq[n].numpy(), err_msg=n)
    for n, vec in weights.vectors.items():
        assert vec.dtype == torch.bfloat16
        np.testing.assert_array_equal(vec.float().numpy(), q[n].numpy(), err_msg=n)
        np.testing.assert_array_equal(deq_port[n].numpy(), deq[n].numpy(), err_msg=n)
    # the scales lie along torch's axis 1 for a transposed conv, the last
    # for a table, 0 otherwise
    shapes = {n: tuple(s.shape) for n, (_, s, _) in weights.quantized.items()}
    if name == "vqvaev2":
        up = [n for n in shapes if ".up." in n]
        assert up and all(shapes[n][0] == 1 and shapes[n][1] > 1 for n in up)
    if name in ("vqreptunet1x1v2", "vqashunetv2"):
        table = [n for n in shapes if n.endswith("embedding")]
        assert table and all(shapes[n] == (1, params[n].shape[1]) for n in table)


@pytest.fixture(scope="module")
def flagship():
    jmodel, v, model, _ = build_flagship(seed=3)
    imgs = np.random.default_rng(4).integers(0, 256, size=(2, HW, HW, 3), dtype=np.uint8)
    return jmodel, v, model, imgs


def test_int8_predictor_agrees_with_f32_and_jax(flagship):
    jmodel, v, model, imgs = flagship
    before = {k: t.clone() for k, t in model.state_dict().items()}
    int8 = Predictor(model, input_hw=(HW, HW), batch_size=2, quant="int8", half=False,
                     device="cpu")
    assert int8.half  # int8 implies bf16 compute
    got = int8(imgs)
    assert got.dtype == np.uint8 and got.shape == (2, HW, HW)
    f32 = Predictor(model, input_hw=(HW, HW), batch_size=2, half=False, device="cpu")(imgs)
    jint8 = JaxPredictor(jmodel, v, input_hw=(HW, HW), batch_size=2, quant="int8")(imgs)
    own, jax_agree = float(np.mean(got == f32)), float(np.mean(got == jint8))
    assert own >= 0.8, own
    assert jax_agree >= 0.8, jax_agree
    for k, t in model.state_dict().items():  # the caller's model is untouched
        assert torch.equal(t, before[k]), k
    assert all(p.dtype == torch.float32 and p.numel() for p in model.parameters())
    bf16_bytes = sum(2 * p.numel() for p in model.parameters())
    assert int8.int8.nbytes() <= 0.55 * bf16_bytes
    assert sum(p.numel() for p in int8.model.parameters()) == 0  # no float copy stays


def test_int8_from_checkpoint(flagship, tmp_path):
    _, _, model, imgs = flagship
    path = str(tmp_path / "last.pt")
    torch.save({"model_1": model.state_dict(), "epoch": 0}, path)
    cfg = Config({"resize": HW, "model": MODEL_CFG})
    pred = Predictor.from_checkpoint(cfg, path, device="cpu", batch_size=2, quant="int8")
    want = Predictor(model, input_hw=(HW, HW), batch_size=2, quant="int8", device="cpu")
    np.testing.assert_array_equal(pred(imgs), want(imgs))
