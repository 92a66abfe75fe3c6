"""Shared helpers of the ``angularv3``/``supconcps``/``semiweed``/``selfsup``
parity tests: the tiny configs, the JAX drivers run with their init and
init phase compiled and their step captured, the port's drivers from JAX's
post-init state, and JAX's one-model step in f64.  Sizes:
resnet18 / K=8 / 64x64, batch 2 + 2 (helpers of the ``vqpt`` tests in
``_vqpt_parity.py`` are reused where they fit)."""
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.config import Config as JaxConfig
from vq_seg_tpu.data import fastimg as jfastimg
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import variant_drivers as jvd
from vq_seg_tpu.training import variants as jvariants
from _port_helpers import MASKS, jax_f64
from _vqpt_parity import _gradient_tx, _np, _tf32_flags
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.training import variant_drivers
from vq_seg_tpu_torch.utils.convert import cps_state_from_flax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))
HW, B = 64, 2
NUM_EMB = [0, 0, 8, 8, 8]


def drv_cfg(data_dir, save_dir, name, **train):
    """A shipped config cut to resnet18, K=8 (where it has codebooks), 64x64,
    batch 2, one epoch, testing every epoch."""
    cfg = json.load(open(os.path.join(ROOT, "config", f"{name}.json")))
    cfg["resize"] = HW
    params = cfg["model"]["params"]
    params["encoder_name"] = "resnet18"
    if "encoder_weights" in params:
        params["encoder_weights"] = None
    if "vq_cfg" in params:
        params["vq_cfg"]["num_embeddings"] = NUM_EMB
    cfg["train"].update(data_dir=data_dir, save_dir=save_dir, num_epochs=1, batch_size=2,
                        **{"test_every": 1, **train})
    cfg["test"].update(data_dir=data_dir, save_dir=os.path.join(save_dir, "..", "test"))
    return cfg


def unimatch_cfg(data_dir, save_dir, **train):
    """``config/semiweednet.json`` (its encoder, resize and batch) cut as
    ``drv_cfg`` cuts it, with the ``unimatch`` network and mode (no shipped
    config has them) and plain CE."""
    cfg = drv_cfg(data_dir, save_dir, "semiweednet", **train)
    cfg.update(mode="unimatch", project_name="unimatch")
    cfg["model"]["name"] = "unimatch"
    cfg["train"]["criterion"] = {"name": "cross_entropy"}
    return cfg


def salient_cfg(data_dir, save_dir, salient_dir, **train):
    """``config/vqreptunet1x1v2.json`` (its encoder and ``vq_cfg``) cut as
    ``drv_cfg`` cuts it, with ``VQUnetwithSalientloss`` and the
    ``salientcps`` mode (no shipped config has them) reading the maps of
    ``salient_dir``."""
    cfg = drv_cfg(data_dir, save_dir, "vqreptunet1x1v2", salient_dir=salient_dir, **train)
    cfg.update(mode="salientcps", project_name="salient")
    p = cfg["model"]["params"]
    cfg["model"] = {"name": "VQUnetwithSalientloss",
                    "params": {k: p[k] for k in ("encoder_name", "num_classes", "vq_cfg")}}
    return cfg


def write_saliency(data_dir, out_dir):
    """The port's ``get_saliency_rbd`` map of every train and test input of
    ``data_dir`` as a gray PNG in ``out_dir`` (by file name)."""
    from PIL import Image

    from vq_seg_tpu_torch.tools.saliency import get_saliency_rbd

    os.makedirs(out_dir, exist_ok=True)
    for split in ("train", "test"):
        folder = os.path.join(data_dir, split, "input")
        for fn in sorted(os.listdir(folder)):
            img = np.asarray(Image.open(os.path.join(folder, fn)).convert("RGB")) / 255.0
            sal = np.round(get_saliency_rbd(img, n_segments=16) * 255).astype(np.uint8)
            Image.fromarray(sal, mode="L").save(os.path.join(out_dir, fn))
    return out_dir


class JitModel:
    """A flax model whose ``init`` and init-phase ``apply`` (a call with
    ``init_codebook``) each run as one compiled program (op by op, flax
    compiles each primitive on its own, about 15 s at resnet18 / 64² with
    an empty cache).  Non-array positional arguments are static.  Every
    other attribute is the model's."""

    def __init__(self, model):
        self._model = model
        self._cache = {}

    def _jitted(self, kind, args, kw, fn):
        statics = tuple((i, a) for i, a in enumerate(args) if not hasattr(a, "shape"))
        key = (kind, statics, len(args), tuple(sorted((k, str(v)) for k, v in kw.items())))
        if key not in self._cache:
            fixed = dict(statics)

            def run(first, arrays):
                it = iter(arrays)
                full = [fixed[i] if i in fixed else next(it) for i in range(len(args))]
                return fn(first, full)

            self._cache[key] = jax.jit(run)
        return self._cache[key]

    def init(self, rngs, *args, **kw):
        f = self._jitted("init", args, kw, lambda r, full: self._model.init(r, *full, **kw))
        return f(rngs, [a for a in args if hasattr(a, "shape")])

    def apply(self, variables, *args, **kw):
        if not kw.get("init_codebook"):
            return self._model.apply(variables, *args, **kw)
        rngs = kw.pop("rngs")
        f = self._jitted("apply", args, kw, lambda v, full: self._model.apply(
            v[0], *full, rngs=v[1], **kw))
        return f((variables, rngs), [a for a in args if hasattr(a, "shape")])

    def __getattr__(self, name):
        return getattr(self._model, name)


def _jit_dual_state(model, tx, sample_args, seed=0):
    """The JAX driver's ``_dual_state`` through ``JitModel.init``."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    v1, v2 = (model.init({"params": k, "dropout": k}, *sample_args, train=True)
              for k in (k1, k2))
    return jvd.CPSTrainState(variables_1=v1, variables_2=v2, opt_state_1=tx.init(v1["params"]),
                             opt_state_2=tx.init(v2["params"]), step=jnp.zeros((), jnp.int32))


def run_jax(driver: str, maker: str, cfg, captured):
    """JAX's ``driver`` for one epoch of 2 steps, its init and init phase
    compiled, its state captured at its step's first call (numpy copies:
    the step donates the state), every step's extra arguments recorded and
    the dropout masks drawn before that call dropped from ``MASKS``."""
    real_make = getattr(jvariants, maker)

    def make_capturing(*a, **k):
        step = real_make(*a, **k)

        def capturing(state, l_img, l_target, ul_img, *extra):
            if "post" not in captured:
                captured["post"] = _np(state)
                MASKS.clear()  # the init's draws
            captured.setdefault("extra", []).append(_np(extra))
            return step(state, l_img, l_target, ul_img, *extra)

        captured["step"] = step
        return capturing

    jfastimg.load()  # before the loader's threads (see _vqpt_parity._run_jax)
    from vq_seg_tpu.models.layers import set_decoder_bn_overrides

    mp = pytest.MonkeyPatch()
    mp.setattr(jvariants, maker, make_capturing)
    if hasattr(jvd, maker):
        mp.setattr(jvd, maker, make_capturing)
    mp.setattr(jvd, "_dual_state", _jit_dual_state)
    mp.setattr(jvd, "make_model", lambda model_cfg: JitModel(jax_make_model(model_cfg)))
    try:
        return _np(getattr(jvd, driver)(JaxConfig(cfg), max_steps_per_epoch=2))
    finally:
        mp.undo()
        set_decoder_bn_overrides(None, None)  # the driver sets this global from the config


@contextlib.contextmanager
def jax_decoder_bn(cfg):
    """The JAX package's decoder BN overrides of ``cfg`` (its drivers set the
    global from ``train.bn_eps``/``bn_momentum``) while JAX traces a step
    outside its driver."""
    from vq_seg_tpu.models.layers import set_decoder_bn_overrides

    set_decoder_bn_overrides(cfg["train"].get("bn_eps"), cfg["train"].get("bn_momentum"))
    try:
        yield
    finally:
        set_decoder_bn_overrides(None, None)


def run_port(driver: str, cfg, captured, patches=None):
    """The port's ``driver`` from JAX's post-init state: its CPS init phase
    loads that state (``patches`` may replace other names of
    ``variant_drivers``).  Returns (state, history, what the init phase
    saw)."""
    seen = {}

    def port_init(state, l_img, l_target, **kw):
        seen["init_kw"] = kw
        seen["tf32_in_driver"] = _tf32_flags()
        return cps_state_from_flax(state, captured["post"], NUM_EMB)

    mp = pytest.MonkeyPatch()
    mp.setattr(variant_drivers, "vqpt_init_phase", port_init)
    for name, value in (patches or {}).items():
        mp.setattr(variant_drivers, name, value)
    history = []
    try:
        state = getattr(variant_drivers, driver)(Config(cfg), max_steps_per_epoch=2,
                                                 device="cpu", history=history)
    finally:
        mp.undo()
    return state, history, seen


def adam_gradient(opt_state):
    """The gradient of Adam's first update, from its first moment."""
    return jax.tree_util.tree_map(lambda mu: mu / np.float32(0.1), opt_state[0].mu)


def jax_f64_one_model_step(make_step, post, args, replay=()):
    """``make_step(tx)``'s one-model step in f64 from ``post`` (a supervised
    ``TrainState`` of numpy leaves) with a gradient-keeping transformation;
    ``replay``: dropout masks used in place of the
    f64 run's own draws.  Returns (the new state, the metrics), numpy
    leaves, the optimizer state holding the gradients."""
    from _port_helpers import replay_dropout

    tx = _gradient_tx()
    post = post.replace(opt_state=_np(tx.init(post.variables["params"])))
    with jax_f64(), replay_dropout(replay):
        w = lambda a: jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)
        new, metrics = make_step(tx)(jax.tree_util.tree_map(w, post),
                                     *[w(np.asarray(a)) if isinstance(a, np.ndarray) else a
                                       for a in args])
        return _np(new), _np(metrics)
