"""Port parity: the training slice against the JAX package, f32 on the CPU,
at resnet18 / K=8 / 64x64, batch 2 labeled + 2 unlabeled.

The JAX side is built once (module fixture): ``create_cps_state`` and
``cps_init_phase`` of the JAX package, carried across with
``cps_state_from_flax``.  JAX's random draws cannot be matched, so the port
starts from JAX's variables instead.

Bounds:
  (a) BatchNorm running stats within 1e-6 of flax's after one train-mode
      forward; ``nn.BatchNorm2d`` misses them by its n/(n-1).
  (b) ``ReliablePrototypeLossv2``: loss, and gradients w.r.t. features and
      table, within 1e-5 relative (L2 for gradients).
  (c) the network's train forward with gt: out within 1e-4, commit and
      proto within 1e-5 relative, usage equal, batch_stats within 1e-5.
  (d) the init phase: encoder BN running stats within 1e-5 of JAX's;
      each codebook and prototype table is the mean of the rows that the
      previous k-means iterate assigned to it (replayed from the model's
      generator), or unchanged.
  (e) one CPS step.  JAX's step runs with an optax transformation that
      keeps the gradient as its state and updates nothing, so its
      gradients are read exactly; the port's are read from ``.grad``.
      Metrics within 1e-4 relative, predictions within 1e-3, batch_stats
      within 1e-5, codebooks unchanged.  Gradients, each tensor of both
      models: the port's f64 step within 1e-6 relative L2 of JAX's step
      run in f64 (x64, with the package's f32 casts widened), the port's
      f32 step within 1e-4 of it, and within 1e-4 of JAX's f32 step plus
      that tensor's own distance between JAX's f32 and f64 steps.  JAX's
      f32 gradients of model 1's shallow encoder are far from its own f64
      step at these shapes; flax's one-pass batch variance
      E[x^2] - E[x]^2 is most of that.
  (f) three Adam steps with the flagship's cosine schedule: metrics within
      1e-3 relative at each step (IoUs also 1e-3 absolute).
"""
import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vq_seg_tpu.losses import make_loss as jax_make_loss
from vq_seg_tpu.models.layers import BatchNorm as JaxBatchNorm
from vq_seg_tpu.models.modules import prototype as jproto
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import cps as jcps
from vq_seg_tpu.training.schedules import cosine_annealing as jax_cosine
from vq_seg_tpu_torch.losses import make_loss
from vq_seg_tpu_torch.models.layers import BatchNorm2d
from vq_seg_tpu_torch.models.modules import prototype as tproto
from vq_seg_tpu_torch.ops.kmeans import kmeans_step, sample_vectors
from vq_seg_tpu_torch.training import cps_init_phase, create_cps_state, make_cps_train_step
from vq_seg_tpu_torch.training.schedules import cosine_annealing
from vq_seg_tpu_torch.utils.convert import cps_state_from_flax, state_dict_from_flax

torch.set_num_threads(1)

HW, B, TH = 64, 2, 0.7
NUM_EMB = [0, 0, 8, 8, 8]
MODEL_CFG = {"name": "vqreptunet1x1v2", "params": {
    "encoder_name": "resnet18", "num_classes": 3,
    "vq_cfg": {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True},
    "margin": 0.5, "scale": 30.0}}
STEP_KW = dict(num_classes=3, confidence_threshold=TH, cps_loss_weight=1.0,
               commitment_loss_weight=1.0, prototype_loss_weight=0.01)
# the random head is scaled so that a share of the pixels is confident
# (the test asserts 20-80 % above th): both sides of every mask are used
HEAD_SCALE = 5.0
METRICS = ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "commitment_loss",
           "prototype_loss", "miou", "iou_list", "code_usage")


def _batch(rng):
    img = rng.uniform(size=(B, HW, HW, 3)).astype(np.float32)
    # every class present: stripes of 0/1/2 with noise
    lab = ((np.arange(HW)[None, :, None] // 8 + rng.integers(0, 2, size=(B, HW, HW))) % 3)
    return img, lab.astype(np.int32), rng.uniform(size=(B, HW, HW, 3)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def jax_side():
    """JAX model, its state before and after the init phase (numpy
    leaves), the post-init state with scaled heads, and the batches."""
    rng = np.random.default_rng(0)
    batches = [_batch(rng) for _ in range(3)]
    l_img, l_t, _ = batches[0]
    jmodel = jax_make_model(MODEL_CFG)
    tx = optax.sgd(1.0)
    pre = jax.jit(lambda x, gt: jcps.create_cps_state(jmodel, tx, (x, gt, TH)))(
        jnp.asarray(l_img), jnp.asarray(l_t))
    post = jax.jit(lambda s, x, gt: jcps.cps_init_phase(jmodel, s, x, gt, TH))(
        pre, jnp.asarray(l_img), jnp.asarray(l_t))
    scaled = _np(post)
    for v in (scaled.variables_1, scaled.variables_2):
        v["params"]["segmentation_head"]["Conv_0"]["kernel"] *= HEAD_SCALE
    return dict(model=jmodel, pre=_np(pre), post=_np(post), scaled=scaled, batches=batches)


def _port(jstate, schedule=lambda step: 1.0):
    st = create_cps_state(MODEL_CFG, schedule, device="cpu")
    return cps_state_from_flax(st, jstate, NUM_EMB)


# -- (a) BatchNorm -------------------------------------------------------------


def test_batch_norm_running_stats_match_flax():
    """8 values per channel, as the stage-5 BNs see at batch 2 of 64x64."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 2, 2, 4)) * [1.0, 2.0, 0.5, 3.0] + [0.5, -1.0, 0.2, 2.0])
    x = x.astype(np.float32)
    ra = {"mean": rng.standard_normal(4).astype(np.float32) * 0.1,
          "var": rng.uniform(0.5, 1.5, 4).astype(np.float32)}
    p = {"scale": rng.uniform(0.5, 1.5, 4).astype(np.float32),
         "bias": rng.standard_normal(4).astype(np.float32) * 0.1}
    y_j, mut = JaxBatchNorm().apply({"params": {"BatchNorm_0": p}, "batch_stats": {"BatchNorm_0": ra}},
                                    jnp.asarray(x), train=True, mutable=["batch_stats"])
    want = mut["batch_stats"]["BatchNorm_0"]

    def run(bn):
        sd = {"weight": torch.from_numpy(p["scale"]), "bias": torch.from_numpy(p["bias"]),
              "running_mean": torch.from_numpy(ra["mean"]), "running_var": torch.from_numpy(ra["var"]),
              "num_batches_tracked": torch.tensor(0)}
        bn.load_state_dict(sd)
        return bn.train()(_nchw(x)), bn

    y, bn = run(BatchNorm2d(4))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want["var"]), rtol=1e-6, atol=1e-7)
    _, plain = run(torch.nn.BatchNorm2d(4))  # the unbiased update this class repairs
    gap = np.abs(plain.running_var.numpy() - np.asarray(want["var"])) / np.asarray(want["var"])
    assert gap.min() > 1e-3, gap
    bn.eval()
    np.testing.assert_array_equal(bn(_nchw(x)).detach().numpy(),
                                  torch.nn.functional.batch_norm(
                                      _nchw(x), bn.running_mean, bn.running_var, bn.weight,
                                      bn.bias, False, 0.1, bn.eps).detach().numpy())


# -- (b) prototype loss ----------------------------------------------------------


@pytest.mark.parametrize("case", ["int-gt", "score-map", "orthogonal-reg", "class-means-init"])
def test_reliable_prototype_loss_v2_matches_jax(case):
    rng = np.random.default_rng(2)
    n, h, w, c, k = 2, 16, 16, 8, 3
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    table = rng.standard_normal((k, c)).astype(np.float32)
    if case == "score-map":  # at twice the feature grid: resized bilinear, masked at th
        gt = (rng.standard_normal((n, 2 * h, 2 * w, k)) * 3).astype(np.float32)
        gt_t = _nchw(gt)
    else:  # at twice the grid: resized nearest
        gt = rng.integers(0, k, size=(n, 2 * h, 2 * w)).astype(np.int32)
        gt_t = torch.from_numpy(gt).long()
    kw = dict(num_classes=k, embedding_dim=c, margin=0.5, scale=30.0)
    if case == "orthogonal-reg":
        kw["orthogonal_reg_weight"] = 0.1
    if case == "class-means-init":
        kw["pt_init"] = "class_means"
    jmod = jproto.ReliablePrototypeLossv2(**kw)
    init = case == "class-means-init"

    def jfn(xx, tt):
        out = jmod.apply({"params": {"embedding": tt}}, xx, jnp.asarray(gt), TH, init_protos=init,
                         mutable=["params"] if init else False)
        return out[0] if init else out

    jl, (jgx, jgt) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    mod = tproto.ReliablePrototypeLossv2(**kw)
    with torch.no_grad():
        mod.embedding.copy_(torch.from_numpy(table))
    xt = _nchw(x).requires_grad_(True)
    loss = mod(xt, gt_t, TH, init_protos=init)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    if init:
        # the init phase is never differentiated (JAX's table there is a
        # function of x, the port's a copy): the table is the class means
        np.testing.assert_allclose(
            mod.embedding.detach().numpy(),
            np.asarray(jproto.class_mean_features(*jproto._flatten_with_gt(jnp.asarray(x), jnp.asarray(gt)), k)),
            rtol=1e-5, atol=1e-6)
    else:
        assert _rel(xt.grad.permute(0, 2, 3, 1).numpy(), jgx) <= 1e-5
        assert _rel(mod.embedding.grad.numpy(), jgt) <= 1e-5


@pytest.mark.parametrize("margin,easy", [(0.5, True), (0.5, False), (1.5, True), (1.5, False)])
def test_prototype_helpers_match_jax(margin, easy):
    rng = np.random.default_rng(3)
    cos = np.linspace(-1.0, 1.0, 201, dtype=np.float32)
    np.testing.assert_allclose(tproto.arcface_phi(torch.from_numpy(cos), margin, easy).numpy(),
                               np.asarray(jproto.arcface_phi(jnp.asarray(cos), margin, easy)),
                               rtol=1e-6, atol=1e-6)
    logits = rng.standard_normal((50, 3)).astype(np.float32)
    pos, mask = logits[:, 0], (rng.uniform(size=50) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        tproto.eps_softmax_ce(*map(torch.from_numpy, (logits, pos, mask))).item(),
        float(jproto.eps_softmax_ce(*map(jnp.asarray, (logits, pos, mask)))), rtol=1e-6)
    t = rng.standard_normal((5, 8)).astype(np.float32)
    np.testing.assert_allclose(tproto.orthogonal_loss_fn(torch.from_numpy(t)).item(),
                               float(jproto.orthogonal_loss_fn(jnp.asarray(t))), rtol=1e-5, atol=1e-7)


# -- (c) network train forward with gt -----------------------------------------------


@pytest.mark.parametrize("arity", ["int-gt", "score-map"])
def test_network_train_forward_with_gt(jax_side, arity):
    jmodel, v = jax_side["model"], jax_side["post"].variables_1
    l_img, l_t, ul = jax_side["batches"][0]
    if arity == "score-map":
        x, gt = ul, (np.random.default_rng(4).standard_normal((B, HW, HW, 3)) * 3).astype(np.float32)
        gt_t = _nchw(gt)
    else:
        x, gt, gt_t = l_img, l_t, torch.from_numpy(l_t).long()
    (jout, jcommit, jusage, jprotol), mut = jax.jit(
        lambda vv, xx, gg: jmodel.apply(vv, xx, gg, TH, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x), jnp.asarray(gt))
    st = _port(jax_side["post"])
    model = st.model_1.train()
    out, commit, usage, proto = model(_nchw(x), gt_t, TH, train=True)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jout), atol=1e-4)
    np.testing.assert_allclose(commit.item(), float(jcommit), rtol=1e-5)
    np.testing.assert_array_equal(usage.numpy(), np.asarray(jusage))
    assert proto.item() > 0
    np.testing.assert_allclose(proto.item(), float(jprotol), rtol=1e-5)
    want = state_dict_from_flax({**v, "batch_stats": _np(mut["batch_stats"])}, NUM_EMB)
    for key, t in model.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=key)


# -- (d) init phase ----------------------------------------------------------------


def _fitted_rows(model, img, gt):
    """The rows each codebook and the prototype table were fitted to: the
    train-mode encoder features at each VQ stage and the decoder output."""
    model = copy.deepcopy(model).train()
    with torch.no_grad():
        feats = model.core.encoder(img)[1:]
        dec = model(img, gt, TH, train=True, return_features=True)[3]
    rows = {f"core.codebooks.{i}.embedding": f.permute(0, 2, 3, 1).reshape(-1, f.shape[1])
            for i, f in enumerate(feats) if NUM_EMB[i] > 0}
    rows["prototype_loss.embedding"] = dec.permute(0, 2, 3, 1).reshape(-1, dec.shape[1])
    return rows


def test_init_phase(jax_side):
    l_img, l_t, _ = jax_side["batches"][0]
    st = _port(jax_side["pre"])
    before = {k: v.clone() for k, v in st.model_1.state_dict().items()}
    cps_init_phase(st, _nchw(l_img), torch.from_numpy(l_t).long(), TH, seed=0)
    assert st.model_1.training and st.model_2.training  # left as found
    for i, (model, jv) in enumerate(((st.model_1, jax_side["post"].variables_1),
                                     (st.model_2, jax_side["post"].variables_2))):
        want = state_dict_from_flax(jv, NUM_EMB)
        sd = model.state_dict()
        enc = [k for k in sd if k.startswith("core.encoder.") and "running" in k]
        assert enc
        for key in enc:
            np.testing.assert_allclose(sd[key].numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=key)
        # the k-means property: each row of the final table is the mean of
        # the rows its previous iterate assigned to it, or unchanged.  The
        # previous iterate is replayed from the model's own generator, which
        # the init phase draws from stage by stage, then for the table.
        generator = torch.Generator().manual_seed(i)
        for key, rows in _fitted_rows(model, _nchw(l_img), torch.from_numpy(l_t).long()).items():
            table = sd[key]
            assert not torch.equal(table, before[key]) or i == 1
            means = sample_vectors(rows, table.shape[0], generator)
            for _ in range(9):
                means, _ = kmeans_step(rows, means)
            last, bins = kmeans_step(rows, means)
            assert int(bins.sum()) == rows.shape[0]
            np.testing.assert_allclose(last.numpy(), table.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=key)
    # the two models drew from their own generators
    assert not torch.equal(st.model_1.prototype_loss.embedding, st.model_2.prototype_loss.embedding)


# -- (e) one CPS step ----------------------------------------------------------------


def _jax_step(jax_side, tx, state_np, steps, dtype=np.float32):
    """``steps`` steps of the JAX package's unfused step from ``state_np``
    (numpy leaves), its f32 leaves and images cast to ``dtype``."""
    dice = jax_make_loss("dice_loss", 3, ignore_index=255)
    step = jcps.make_cps_train_step(jax_side["model"], tx, dice, **STEP_KW)
    wide = lambda a: jnp.asarray(a.astype(dtype) if a.dtype == np.float32 else a)
    state = jax.tree_util.tree_map(wide, state_np)
    out = []
    for l_img, l_t, ul in jax_side["batches"][:steps]:
        state, metrics, ps, pu = step(state, wide(l_img), jnp.asarray(l_t), wide(ul))
        out.append((_np(metrics), np.asarray(ps), np.asarray(pu)))
    return _np(state), out


def _port_step(st, batches, dtype=torch.float32):
    step = make_cps_train_step(make_loss("dice_loss", 3, ignore_index=255), **STEP_KW)
    out = []
    for l_img, l_t, ul in batches:
        st, metrics, ps, pu = step(st, _nchw(l_img).to(dtype), torch.from_numpy(l_t).long(),
                                   _nchw(ul).to(dtype))
        out.append((metrics, ps, pu))
    return out


def _gradient_tx():
    """Updates nothing and keeps the last gradient as its state."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)
    return optax.GradientTransformation(zeros, lambda grads, state, params=None: (zeros(grads), grads))


def test_one_cps_step_matches_jax(jax_side, monkeypatch):
    tx = _gradient_tx()
    scaled = jax_side["scaled"]
    scaled = scaled.replace(opt_state_1=_np(tx.init(scaled.variables_1["params"])),
                            opt_state_2=_np(tx.init(scaled.variables_2["params"])))
    jnew, [(jm, jps, jpu)] = _jax_step(jax_side, tx, scaled, 1)
    # the same JAX step in f64: x64 on, and the package's f32 casts widened
    with jax.enable_x64(True), mock.patch.object(jnp, "float32", jnp.float64):
        jnew64, _ = _jax_step(jax_side, tx, scaled, 1, np.float64)
    assert jnew64.opt_state_1["segmentation_head"]["Conv_0"]["kernel"].dtype == np.float64

    st = _port(scaled)
    [(m, ps, pu)] = _port_step(st, jax_side["batches"][:1])
    conf = torch.softmax(torch.cat([ps, pu]), 1).amax(1) > TH
    assert 0.2 <= conf.float().mean().item() <= 0.8
    for key in METRICS:
        np.testing.assert_allclose(m[key].numpy(), jm[key], rtol=1e-4, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(ps.permute(0, 2, 3, 1).numpy(), jps, atol=1e-3)
    np.testing.assert_allclose(pu.permute(0, 2, 3, 1).numpy(), jpu, atol=1e-3)

    # the same port step in f64: ``.float()`` leaves f64 tensors as they are
    f32 = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda t: t if t.dtype == torch.float64 else f32(t))
    st64 = _port(scaled)
    st64.model_1.double()
    st64.model_2.double()
    _port_step(st64, jax_side["batches"][:1], torch.float64)
    monkeypatch.undo()

    for model, model64, jv, jg32, jg64 in (
            (st.model_1, st64.model_1, jnew.variables_1, jnew.opt_state_1, jnew64.opt_state_1),
            (st.model_2, st64.model_2, jnew.variables_2, jnew.opt_state_2, jnew64.opt_state_2)):
        jg32 = state_dict_from_flax({**jv, "params": jg32}, NUM_EMB)
        jg64 = state_dict_from_flax({**jv, "params": jg64}, NUM_EMB)
        g64 = dict(model64.named_parameters())
        for name, p in model.named_parameters():
            want = jg64[name].numpy()
            assert _rel(g64[name].grad.numpy(), want) <= 1e-6, name
            assert _rel(p.grad.numpy(), want) <= 1e-4, name
            assert _rel(p.grad.numpy(), jg32[name].numpy()) <= 1e-4 + _rel(jg32[name].numpy(), want), name
        want = state_dict_from_flax(jv, NUM_EMB)
        for key, t in model.state_dict().items():
            if "running" in key:
                np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=key)
            if "codebooks" in key:  # frozen: bitwise as before the step
                np.testing.assert_array_equal(t.numpy(), want[key].numpy(), err_msg=key)
    assert st.step == 1


# -- (f) three Adam steps ------------------------------------------------------------------


def test_three_adam_steps_with_the_cosine_schedule(jax_side):
    lr, min_lr, total = 1e-4, 1e-7, 10  # the flagship's rates
    tx = optax.adam(jax_cosine(lr, min_lr, total), b1=0.9, b2=0.999)
    scaled = jax_side["scaled"]
    scaled = scaled.replace(opt_state_1=_np(tx.init(scaled.variables_1["params"])),
                            opt_state_2=_np(tx.init(scaled.variables_2["params"])))
    _, jout = _jax_step(jax_side, tx, scaled, 3)
    st = _port(scaled, schedule=cosine_annealing(lr, min_lr, total))
    out = _port_step(st, jax_side["batches"])
    for i, ((m, _, _), (jm, _, _)) in enumerate(zip(out, jout)):
        for key in METRICS:
            # IoUs count pixels: one pixel that flips class moves them by
            # about 1e-4 here, so they are held to 1e-3 absolute as well
            atol = 1e-3 if key in ("miou", "iou_list") else 1e-6
            np.testing.assert_allclose(m[key].numpy(), jm[key], rtol=1e-3, atol=atol,
                                       err_msg=f"step {i}: {key}")
    assert st.step == 3
