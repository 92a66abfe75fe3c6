"""Port parity: one ``reptcps`` step of ``vqreptunetangular``
(``config/vqreptunetangular.json`` trains under ``--mode reptcps``) against
the JAX package, on the CPU at resnet18 / K=8 / 64x64, batch 2 labeled + 2
unlabeled (helpers in ``_vqpt_parity.py``; the network's forwards are in
``test_torch_angular.py``).

Both packages start from the same seeded variables (two draws) with a
fresh Adam; JAX's step is compiled as its driver compiles it.  On
zero-mean images at drop percent 80: loss terms within 1e-5 relative (IoUs
1e-5 absolute), running statistics within 1e-5, codebooks unchanged;
``scale`` 30 with a margin makes the gradients ill-conditioned in f32, so
they are held in f64 in both packages within 1e-6 and the port's f32
within 1e-4 plus twice JAX's own f32 error of JAX's f64; every forward
sees TF32 off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from vq_seg_tpu.losses import make_loss as jax_make_loss
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import variants as jvariants
from vq_seg_tpu.training.cps import CPSTrainState as JaxCPSTrainState
from _port_helpers import nchw, to_np
from _seeded_flax import seeded_variables
from _slice_parity import NUM_EMB
from _vqpt_parity import _adam_gradient, _batch, _check_step, _jax_f64_step, _port_step
from vq_seg_tpu_torch.losses import make_loss
from vq_seg_tpu_torch.training.variants import make_rept_cps_train_step

torch.set_num_threads(1)

METRICS = ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "commitment_loss", "prototype_loss",
           "code_usage", "miou", "iou_list")
STEP_KW = dict(num_classes=3, cps_loss_weight=1.0, commitment_loss_weight=1.0,
               prototype_loss_weight=0.01)


def _model_cfg():
    return {"name": "vqreptunetangular", "params": {
        "encoder_name": "resnet18", "num_classes": 3, "margin": 0.5, "scale": 30.0,
        "vq_cfg": {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True}}}


def test_one_reptcps_step_of_vqreptunetangular_matches_jax():
    """From seeded variables (two draws) with a fresh Adam, the JAX
    ``reptcps`` step compiled as its driver compiles it."""
    cfg = _model_cfg()
    jmodel = jax_make_model(cfg)
    batch = _batch(8)
    x, gt = batch[0], batch[1]
    tx = optax.adam(1e-4)
    vs = [to_np(seeded_variables(jmodel, (jnp.asarray(x), jnp.asarray(gt), 100.0), seed=s,
                                 train=True)) for s in (0, 1)]
    post = JaxCPSTrainState(variables_1=vs[0], variables_2=vs[1],
                            opt_state_1=to_np(tx.init(vs[0]["params"])),
                            opt_state_2=to_np(tx.init(vs[1]["params"])),
                            step=np.zeros((), np.int32))
    jstep = jvariants.make_rept_cps_train_step(
        jmodel, tx, jax_make_loss("dice_loss", 3, ignore_index=255), **STEP_KW)
    jnew, jm = jstep(jax.tree_util.tree_map(jnp.asarray, post), *map(jnp.asarray, batch),
                     jnp.float32(80.0))
    jnew, jm = to_np(jnew), to_np(jm)
    step = make_rept_cps_train_step(make_loss("dice_loss", 3, ignore_index=255), **STEP_KW)
    l_img, l_t, ul = batch
    args = (nchw(l_img), torch.from_numpy(l_t).long(), nchw(ul), 80.0)
    st, m = _port_step(cfg, post, step, args)
    st64, _ = _port_step(cfg, post, step, args, torch.float64)
    jnew64 = _jax_f64_step(lambda t: jvariants.make_rept_cps_train_step(
        jmodel, t, jax_make_loss("dice_loss", 3, ignore_index=255), **STEP_KW),
        post, (*batch, 80.0))
    _check_step(st, m, post, jnew, jm, (_adam_gradient(jnew.opt_state_1),
                                        _adam_gradient(jnew.opt_state_2)), METRICS,
                f64=(st64, (jnew64.opt_state_1, jnew64.opt_state_2)))


