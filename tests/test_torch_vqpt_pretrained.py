"""Port parity, the rest of the ``vqpt`` slice's training paths against
the JAX package, f32 on the CPU, at resnet18 / K=8 / 64x64, batch 2
labeled + 2 unlabeled (helpers in ``_vqpt_parity.py``):

  * the pretrained flow: one ``vqpt`` epoch with ``train.pretrained`` set,
    from files of one numpy-seeded tree in each package (JAX's orbax
    trees, the port's ``save_vqvae``), against JAX's ``train_vqpt_cps``,
    the port from JAX's post-init state: the port's loaded encoder and
    codebooks equal JAX's bitwise, the encoder frozen out of Adam, the
    init phase without the codebooks' k-means, the epoch's averages within
    1e-3 relative (mIoU 1e-3 absolute) with the same run directory and
    contract, the encoder's parameters bitwise unchanged after it while
    its running statistics and the decoder moved;
  * one ``vqpt`` step on ``vqashunetv2`` (CE, the angular weight 1, the
    head's commitment at 10) from numpy-seeded variables, JAX's step
    compiled with an optax transformation that keeps the gradient, on
    zero-mean images: loss terms within 1e-5 relative (IoUs 1e-5
    absolute), BN running stats within 1e-5, codebooks unchanged, every
    gradient within 1e-4 relative L2 of JAX's f32, the head's embeddings
    among them.  (On [0, 1] images its f32 encoder gradients differ by
    3e-3 between the packages.)
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import os

import jax
import jax.numpy as jnp
import torch

from vq_seg_tpu.losses import make_loss as jax_make_loss
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import variant_drivers as jvd
from vq_seg_tpu.training import variants as jvariants
from vq_seg_tpu.utils import ckpoints as jck
from _seeded_flax import seeded_variables
from _vqpt_parity import (NUM_EMB, STEP_KW, VQPT_METRICS, _batch, _check_epoch, _check_step,
                          _drv_cfg, _gradient_tx, _nchw, _np, _port_step, _run_jax, _run_port)
from vq_seg_tpu_torch.losses import make_loss
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.training.variants import make_vqpt_cps_train_step
from vq_seg_tpu_torch.utils import ckpoints
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax

torch.set_num_threads(1)


# -- the pretrained, frozen-encoder flow --------------------------------------------------


def test_pretrained_vqpt_epoch_matches_jax(synthetic_dataset, tmp_path):
    """Files of one numpy-seeded tree in each package (JAX's orbax trees,
    the port's ``save_vqvae`` of the same values), then one ``vqpt`` epoch
    with ``train.pretrained`` in each."""
    base = tmp_path
    x, gt, _ = _batch(11)
    v = seeded_variables(jax_make_model(_drv_cfg("", "")["model"]),
                         (jnp.asarray(x), jnp.asarray(gt)), seed=5, train=True)
    jdir, pdir = base / "jax_vqvae", base / "port_vqvae"
    jck._save_tree(str(jdir / "0ep_encoder.ckpt"), {
        "params": v["params"]["core"]["encoder"], "batch_stats": v["batch_stats"]["core"]["encoder"]})
    jck._save_tree(str(jdir / "0ep_codebook.ckpt"), v["codebook"]["core"])
    src = make_model(_drv_cfg("", "")["model"], device="cpu")
    src.load_state_dict(state_dict_from_flax(v, NUM_EMB))
    os.makedirs(pdir)
    ckpoints.save_vqvae(src, 0, str(pdir))

    def cfg_for(side, ck_dir):
        return _drv_cfg(synthetic_dataset, str(base / f"{side}_pre"), pretrained={
            "encoder": str(ck_dir / "0ep_encoder.ckpt"),
            "codebook": str(ck_dir / "0ep_codebook.ckpt")})

    captured = {}
    _run_jax("vqpt", cfg_for("jax", jdir), captured)
    frozen = {k: t.clone() for k, t in src.state_dict().items()
              if k.startswith(("core.encoder.", "core.codebooks."))}

    def check_pre(state):
        for model in (state.model_1, state.model_2):  # the port's own load
            sd = model.state_dict()
            for k, t in frozen.items():
                if "running" not in k and "num_batches" not in k:
                    assert torch.equal(sd[k], t), k
        assert all(not p.requires_grad for n, p in state.model_1.named_parameters()
                   if n.startswith("core.encoder."))
        trained = {id(p) for g in state.opt_1.param_groups for p in g["params"]}
        assert trained == {id(p) for n, p in state.model_1.named_parameters()
                           if not n.startswith("core.encoder.")}

    state, history, seen = _run_port("vqpt", cfg_for("port", pdir), captured, check_pre)
    assert seen["init_kw"] == {"init_codebook": False}  # the prototype table only
    _check_epoch(str(base / "jax_pre" / "VQPTUnet_vqpt_0"),
                 str(base / "port_pre" / "VQPTUnet_vqpt_0"), "vqpt")
    post = state_dict_from_flax(captured["post"].variables_1, NUM_EMB)
    sd = state.model_1.state_dict()
    for k, t in frozen.items():
        if "running" in k:
            assert not torch.equal(sd[k], t), k  # BN statistics move in train mode
        elif "num_batches" not in k:
            assert torch.equal(sd[k], t), k  # encoder and codebooks bitwise
    moved = [k for k, p in state.model_1.named_parameters()
             if not k.startswith("core.encoder.") and not torch.equal(sd[k], post[k])]
    assert "segmentation_head.weight" in moved and any(k.startswith("core.decoder.") for k in moved)


def test_one_vqpt_step_on_the_v2_head_matches_jax():
    """``vqashunetv2`` (CE, the angular weight 1, the head's commitment at
    10): JAX's step compiled with a gradient-keeping transformation, from
    numpy-seeded variables; the head's embeddings train."""
    cfg = _drv_cfg("", "", "vqashv2")
    batch = _batch(9)
    jmodel = jax_make_model(cfg["model"])
    l_img, l_t, ul = batch
    vs = [seeded_variables(jmodel, (jnp.asarray(l_img), jnp.asarray(l_t)), seed=s, train=True)
          for s in (0, 1)]
    tx = _gradient_tx()
    post = jvd.CPSTrainState(variables_1=vs[0], variables_2=vs[1],
                             opt_state_1=tx.init(vs[0]["params"]),
                             opt_state_2=tx.init(vs[1]["params"]), step=jnp.zeros((), jnp.int32))
    kw = dict(STEP_KW, prototype_loss_weight=1.0)
    jstep = jvariants.make_vqpt_cps_train_step(
        jmodel, tx, jax_make_loss("cross_entropy", 3, ignore_index=255), **kw)
    post = _np(post)
    jnew, jm = jstep(jax.tree_util.tree_map(jnp.asarray, post), *map(jnp.asarray, batch))
    jnew, jm = _np(jnew), _np(jm)
    step = make_vqpt_cps_train_step(make_loss("cross_entropy", 3, ignore_index=255), **kw)
    st, m = _port_step(cfg["model"], post, step, (_nchw(l_img), torch.from_numpy(l_t).long(),
                                                  _nchw(ul)))
    _check_step(st, m, post, jnew, jm, (jnew.opt_state_1, jnew.opt_state_2), VQPT_METRICS)
    assert st.model_1.segmentation_head.embedding.grad.abs().sum() > 0
