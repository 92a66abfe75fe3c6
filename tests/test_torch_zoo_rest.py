"""Port parity: the last networks of the registry without a slice of their
own, ``vqunet_v1``, ``unetoriginal``, ``nopt`` and ``scheme6``, against the
JAX package on the CPU (helpers in ``_port_helpers.py``).

The port starts from JAX's variables (drawn from a numpy seed,
``_seeded_flax``), mapped by ``utils/convert.py``.  Sizes: resnet18 / K=8
/ 64x64 for the VQ networks, ``unetoriginal`` at 164x164 (its bottleneck
then sees 3x3 values per image; 129 is the least size its VALID convs
take) with 8 first channels; batch 2.

Bounds:
  * eval forwards: logits within 1e-5 relative L2, commitment and usage
    within 1e-5;
  * train forwards (batch statistics over 2 to 32 values per channel in
    ``unetoriginal``'s deepest stages and the resnet's, ill-conditioned in
    f32): in f64 in both packages within 1e-7 (the JAX package's x2
    align-corners upsample keeps f32 lerp weights in f64: 3.6e-8), in f32
    within 1e-5 plus twice JAX's own f32 error of JAX's f64; the
    prototype loss of ``scheme6`` likewise, ``nopt``'s exactly 0;
  * one ``cps`` step of ``scheme6`` (the flagship's step and config):
    JAX's own ``scheme6`` fails on the other model's score map (its plain
    prototype loss flattens the map as labels, ROADMAP.md section 3), the
    port takes its argmax, so the reference is the JAX step with the
    network's ``gt`` mapped the same way: the f32 loss terms within 1e-5;
    the gradients in f64 in both packages within 1e-6.  The step's f32
    gradients turn on discrete choices (the CPS targets masked at
    confidence 0.7, the argmax pseudo-labels of the prototype loss) that
    f32 rounding flips: the port's f32 conv1 gradient lies 1.6e-3 from
    JAX's f64 where JAX's own f32 lies 1.5e-5, while both f64 steps
    agree to 1e-6, so f32 gradients are not compared;
  * one ``sup`` step of ``unetoriginal``: in f64 in both packages, loss
    within 1e-9 and gradients within 1e-6 relative L2; in f32 within 1e-4
    plus twice JAX's own f32 error (the biases of the convs under a BN,
    whose gradients are zero up to rounding, within 1e-12 in f64 and 1e-6
    in f32 absolute).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.losses import make_loss as jax_make_loss
from vq_seg_tpu.models.networks import ablation as jablation
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import cps as jcps
from vq_seg_tpu.training import supervised as jsup
from _port_helpers import jax_f64, nchw, nhwc, port_f64, rel, to_np, wide
from _seeded_flax import seeded_variables
from _vqpt_parity import _gradient_tx
from vq_seg_tpu_torch.losses import make_loss
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.training import make_cps_train_step, make_sup_train_step
from vq_seg_tpu_torch.training.cps import CPSTrainState, _adam
from vq_seg_tpu_torch.training.supervised import TrainState
from vq_seg_tpu_torch.utils import convert

torch.set_num_threads(1)

NUM_EMB = [0, 0, 8, 8, 8]
VQ = {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True}
CFGS = {
    "vqunet_v1": (dict(encoder_name="resnet18", num_classes=3, vq_cfg=VQ), 64, [0, 0, 0, 0, 8]),
    "unetoriginal": (dict(num_classes=3, first_outchannels=8), 164, None),
    "nopt": (dict(encoder_name="resnet18", num_classes=3, vq_cfg=VQ), 64, NUM_EMB),
    "scheme6": (dict(encoder_name="resnet18", num_classes=3, vq_cfg=VQ), 64, NUM_EMB),
}


def _inputs(hw, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    gt = ((np.arange(hw)[None, :, None] // 8 + rng.integers(0, 2, (2, hw, hw))) % 3)
    return x, gt.astype(np.int32)


def _wide_sd(variables, num_emb):
    with mock.patch.object(convert, "_t", lambda a: torch.tensor(np.asarray(a, np.float64))):
        return convert.state_dict_from_flax(variables, num_emb)


def _args(name, x, gt):
    return (x,) if name in ("vqunet_v1", "unetoriginal") else (x, gt, 80.0)


def _outs(out):
    """A network's output tuple as a list of arrays (None left out)."""
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,)) if o is not None]


def _port_outs(out):
    out = out if isinstance(out, tuple) else (out,)
    return [(nhwc(o) if o.dim() == 4 else o.detach().numpy()) for o in out if o is not None]


@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_matches_jax(name):
    params, hw, num_emb = CFGS[name]
    x, gt = _inputs(hw)
    jmodel = jax_make_model({"name": name, "params": params})
    jargs = _args(name, jnp.asarray(x), jnp.asarray(gt))
    v = to_np(seeded_variables(jmodel, jargs, train=True))
    model = make_model({"name": name, "params": params}, device="cpu")
    model.load_state_dict(convert.state_dict_from_flax(v, num_emb))
    targs = _args(name, nchw(x), torch.from_numpy(gt).long())
    want = _outs(jax.jit(lambda vv: jmodel.apply(vv, *jargs, train=False))(v))
    with torch.no_grad():
        got = _port_outs(model.eval()(*targs, train=False))
    assert len(got) == len(want) and got[0].shape == want[0].shape
    for g, w in zip(got, want):
        assert rel(g, w) <= 1e-5

    # train mode: the outputs and the running statistics, f32 and f64
    jtrain = lambda vv, *a: jmodel.apply(vv, *a, train=True, mutable=["batch_stats"])
    j32, mut32 = jax.jit(jtrain)(v, *jargs)
    with jax_f64():
        a64 = [jnp.asarray(a, jnp.float64) if a.dtype == jnp.float32 else a
               for a in _args(name, jnp.asarray(x), jnp.asarray(gt))[:2]] + list(jargs[2:])
        j64, mut64 = jax.jit(jtrain)(wide(v), *a64)
    j32, j64 = _outs(j32), _outs(j64)
    with torch.no_grad():
        got32 = _port_outs(model.train()(*targs, train=True))
    stats32 = {k: t.clone() for k, t in model.state_dict().items() if "running" in k}
    model.load_state_dict(convert.state_dict_from_flax(v, num_emb))
    model.double()
    with torch.no_grad(), port_f64():
        got64 = _port_outs(model.train()(*((nchw(x).double(),) + targs[1:]), train=True))
    assert len(got32) == len(j32) == len(got64)
    for g32, g64, w32, w64 in zip(got32, got64, j32, j64):
        if not np.asarray(w64).any():  # nopt's constant 0
            assert not np.asarray(g32).any() and not np.asarray(g64).any()
            continue
        assert rel(g64, w64) <= 1e-7
        assert rel(g32, w64) <= 1e-5 + 2 * rel(w32, w64)
    want32 = convert.state_dict_from_flax({**v, "batch_stats": to_np(mut32["batch_stats"])},
                                          num_emb)
    want64 = _wide_sd({**wide(v), "batch_stats": to_np(mut64["batch_stats"])}, num_emb)
    sd64 = model.state_dict()
    for key, t in stats32.items():
        w64 = want64[key].numpy()
        assert rel(sd64[key].numpy(), w64) <= 1e-7, key
        assert rel(t.numpy(), w64) <= 1e-5 + 2 * rel(want32[key].numpy(), w64), key
    if name == "vqunet_v1":  # one codebook, at the deepest stage
        assert [k for k in model.state_dict() if "codebooks" in k] == [
            "core.codebooks.4.embedding"]


class _Scheme6Argmax(jablation.Scheme6):
    """JAX's ``scheme6`` with a score-map ``gt`` taken to its argmax, as the
    port does (the JAX network fails on the map)."""

    def __call__(self, x, gt=None, percent=None, train: bool = False,
                 init_codebook: bool = False, init_protos: bool = False):
        if gt is not None and gt.ndim == 4:
            gt = jnp.argmax(gt, -1)
        return super().__call__(x, gt, percent, train=train, init_codebook=init_codebook,
                                init_protos=init_protos)


def test_scheme6_cps_step_matches_jax():
    params, hw, num_emb = CFGS["scheme6"]
    x, gt = _inputs(hw, 1)
    ul = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    jmodel = jax_make_model({"name": "scheme6", "params": params})
    v1, v2 = (to_np(seeded_variables(jmodel, (jnp.asarray(x), jnp.asarray(gt), 0.7), seed=s,
                                     train=True)) for s in (0, 1))
    # the JAX network itself fails on the other model's score map
    score = jax.nn.softmax(jnp.asarray(ul), -1)  # an (N, H, W, 3) score map
    with pytest.raises(TypeError, match="broadcast"):
        jmodel.apply(v1, jnp.asarray(ul), score, 0.7, train=True, mutable=["batch_stats"])

    fixed = _Scheme6Argmax(**{k: getattr(jmodel, k) for k in params})
    jcrit = jax_make_loss("dice_loss", 3, ignore_index=255)
    tx = _gradient_tx()
    post = jcps.CPSTrainState(variables_1=v1, variables_2=v2,
                              opt_state_1=to_np(tx.init(v1["params"])),
                              opt_state_2=to_np(tx.init(v2["params"])),
                              step=np.zeros((), np.int32))
    args = (x, gt, ul)

    def jstep(dtype):
        make = lambda: jcps.make_cps_train_step(fixed, tx, jcrit, num_classes=3, remat=False)
        if dtype == "f32":
            new, m, *_ = make()(jax.tree_util.tree_map(jnp.asarray, post),
                                *[jnp.asarray(a) for a in args])
            return to_np(new), to_np(m)
        with jax_f64():
            w = lambda a: jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)
            new, m, *_ = make()(jax.tree_util.tree_map(w, post), *[w(a) for a in args])
            return to_np(new), to_np(m)

    jnew, jm = jstep("f32")
    jnew64, _ = jstep("f64")

    def port(dtype):
        models = []
        for v in (v1, v2):
            m = make_model({"name": "scheme6", "params": params}, device="cpu")
            m.load_state_dict(convert.state_dict_from_flax(v, num_emb))
            models.append(m.to(dtype).train())
        st = CPSTrainState(models[0], models[1], _adam(models[0].parameters()),
                           _adam(models[1].parameters()), lambda s: 0.0)
        step = make_cps_train_step(make_loss("dice_loss", 3, ignore_index=255), num_classes=3)
        with port_f64():
            out = step(st, nchw(x).to(dtype), torch.from_numpy(gt).long(), nchw(ul).to(dtype))
        return st, out[1]

    st, m = port(torch.float32)
    st64, _ = port(torch.float64)
    for k in ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "commitment_loss",
              "prototype_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(jm["prototype_loss"]) > 0
    for i, (model, model64) in enumerate(((st.model_1, st64.model_1),
                                          (st.model_2, st64.model_2))):
        jv = (v1, v2)[i]
        want32 = convert.state_dict_from_flax(
            {**jv, "params": (jnew.opt_state_1, jnew.opt_state_2)[i]}, num_emb)
        want64 = _wide_sd({**wide(jv), "params": (jnew64.opt_state_1, jnew64.opt_state_2)[i]},
                          num_emb)
        g64 = dict(model64.named_parameters())
        for pname, p in model.named_parameters():
            w64 = want64[pname].numpy()
            if not w64.any():  # the detached prototype table
                assert p.grad is None or not p.grad.any(), pname
                continue
            assert rel(g64[pname].grad.numpy(), w64) <= 1e-6, pname
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), pname


def test_unetoriginal_sup_step_matches_jax():
    params, hw, _ = CFGS["unetoriginal"]
    x, gt = _inputs(hw, 3)
    jmodel = jax_make_model({"name": "unetoriginal", "params": params})
    v = to_np(seeded_variables(jmodel, (jnp.asarray(x),), train=True))
    tx = _gradient_tx()
    post = jsup.TrainState(variables=v, opt_state=to_np(tx.init(v["params"])),
                           step=np.zeros((), np.int32))
    jcrit = jax_make_loss("dice_loss", 3, ignore_index=255)

    def jstep(f64):
        step = jsup.make_sup_train_step(jmodel, tx, jcrit, num_classes=3, forward_mode="plain")
        if not f64:
            new, m, _ = step(jax.tree_util.tree_map(jnp.asarray, post), jnp.asarray(x),
                             jnp.asarray(gt), None)
            return to_np(new), to_np(m)
        with jax_f64():
            w = lambda a: jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)
            new, m, _ = step(jax.tree_util.tree_map(w, post), w(x), w(gt), None)
            return to_np(new), to_np(m)

    jnew, jm = jstep(False)
    jnew64, jm64 = jstep(True)

    def port(dtype):
        model = make_model({"name": "unetoriginal", "params": params}, device="cpu")
        model.load_state_dict(convert.state_dict_from_flax(v, None))
        model.to(dtype)
        st = TrainState(model, _adam(model.parameters()), lambda s: 0.0)
        step = make_sup_train_step(make_loss("dice_loss", 3, ignore_index=255), num_classes=3,
                                   forward_mode="plain")
        with port_f64():
            _, m, _ = step(st, nchw(x).to(dtype), torch.from_numpy(gt).long(), None)
        return st, m

    st, m = port(torch.float32)
    st64, m64 = port(torch.float64)
    for k in ("loss", "sup_loss"):
        want64 = float(jm64[k])
        assert abs(float(m64[k]) / want64 - 1) <= 1e-9, k
        assert abs(float(m[k]) / want64 - 1) <= 1e-5 + 2 * abs(float(jm[k]) / want64 - 1), k
    assert float(m["commitment_loss"]) == float(m["prototype_loss"]) == 0.0
    want32 = convert.state_dict_from_flax({**v, "params": jnew.opt_state}, None)
    want64 = _wide_sd({**wide(v), "params": jnew64.opt_state}, None)
    g64 = dict(st64.model.named_parameters())
    for pname, p in st.model.named_parameters():
        w64 = want64[pname].numpy()
        if np.abs(w64).max() < 1e-12:  # a conv bias under BN: zero up to rounding
            assert np.abs(g64[pname].grad.numpy()).max() < 1e-12, pname
            assert np.abs(p.grad.numpy()).max() < 1e-6, pname
            continue
        assert rel(g64[pname].grad.numpy(), w64) <= 1e-6, pname
        assert rel(p.grad.numpy(), w64) <= 1e-4 + 2 * rel(want32[pname].numpy(), w64), pname
