"""Port parity: ``vq_seg_tpu_torch.serving.Predictor`` against the JAX
package's ``Predictor``, f32 on the CPU, at resnet18 / K=8 / 64x64.

Labels must be equal except at pixels whose JAX top-2 logit gap is below
2e-3 (there the two f32 forwards may legitimately order the classes
differently).  Also pinned: ``output_hw``, partial-batch padding,
``predict_stream`` against sequential calls, bf16 against f32, the
checkpoint round trip, and that the entry points refuse to run on the CPU
unless asked.
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import HW, MODEL_CFG, build_flagship
from vq_seg_tpu.models.layers import resize_bilinear as jax_resize_bilinear
from vq_seg_tpu.serving import Predictor as JaxPredictor
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.serving import Predictor

torch.set_num_threads(1)

GAP = 2e-3


@pytest.fixture(scope="module")
def setup():
    jmodel, v, model, _ = build_flagship(seed=1)
    imgs = np.random.default_rng(2).integers(0, 256, size=(2, HW, HW, 3), dtype=np.uint8)
    return jmodel, v, model, imgs


def _decided(jax_logits) -> np.ndarray:
    """Pixels whose top-2 logit gap is at least GAP."""
    top2 = np.sort(np.asarray(jax_logits), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) >= GAP


def _jax_logits(jmodel, v, imgs):
    return jmodel.apply(v, jnp.asarray(imgs, jnp.float32) / 255.0, train=False)[0]


def _port(model, **kw):
    return Predictor(model, input_hw=(HW, HW), batch_size=2, half=False, device="cpu", **kw)


@pytest.mark.parametrize("output_hw", [None, (96, 80)])
def test_f32_predictor_matches_jax_predictor(setup, output_hw):
    jmodel, v, model, imgs = setup
    want = JaxPredictor(jmodel, v, input_hw=(HW, HW), batch_size=2, half=False,
                        output_hw=output_hw)(imgs)
    got = _port(model, output_hw=output_hw)(imgs)
    shape = (2, *(output_hw or (HW, HW)))
    assert got.dtype == np.uint8 and got.shape == want.shape == shape
    logits = _jax_logits(jmodel, v, imgs)
    if output_hw is not None:
        logits = jax_resize_bilinear(logits, output_hw)
    decided = _decided(logits)
    assert decided.mean() > 0.9  # the check is not vacuous
    np.testing.assert_array_equal(got[decided], want[decided])


def test_partial_batch_and_stream(setup):
    _, _, model, imgs = setup
    pred = _port(model)
    full = pred(imgs)
    one = pred(imgs[:1])
    assert one.shape == (1, HW, HW)
    np.testing.assert_array_equal(one[0], full[0])
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 256, size=(2, HW, HW, 3), dtype=np.uint8)
               for _ in range(3)] + [imgs[:1]]
    seq = [pred(b) for b in batches]
    piped = list(pred.predict_stream(batches))
    assert len(piped) == len(seq)
    for a, b in zip(piped, seq):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pred(np.concatenate([imgs, imgs]))  # more than batch_size
    with pytest.raises(ValueError):
        pred(imgs[:, :HW // 2])


def test_bf16_profile_close_to_f32(setup):
    _, _, model, imgs = setup
    a = _port(model)(imgs)
    b = Predictor(model, input_hw=(HW, HW), batch_size=2, half=True, device="cpu")(imgs)
    agreement = float(np.mean(a == b))
    assert agreement >= 0.8, agreement


@pytest.mark.parametrize("contract", [True, False])
def test_from_checkpoint_roundtrip(setup, tmp_path, contract):
    _, _, model, imgs = setup
    path = str(tmp_path / "last.pt")
    sd = model.state_dict()
    torch.save({"model_1": sd, "epoch": 3} if contract else sd, path)
    cfg = Config({"resize": HW, "model": MODEL_CFG})
    pred = Predictor.from_checkpoint(cfg, path, device="cpu", batch_size=2, half=False)
    np.testing.assert_array_equal(pred(imgs), _port(model)(imgs))


def test_unported_options_and_missing_card_raise(setup, tmp_path):
    _, _, model, _ = setup
    with pytest.raises(ValueError):
        _port(model, quant="int4")
    assert _port(model, quant="int8").int8 is not None  # ported: builds
    with pytest.raises(NotImplementedError, match="ROADMAP"):  # mesh serving is ported
        _port(model, mesh=["cpu"], spatial=True)
    if not torch.cuda.is_available():
        # the entry points default to the card and never carry on on the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Predictor(model, input_hw=(HW, HW))
        path = str(tmp_path / "sd.pt")
        torch.save(model.state_dict(), path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Predictor.from_checkpoint(Config({"resize": HW, "model": MODEL_CFG}), path)
