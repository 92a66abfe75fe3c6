"""Shared helpers of ``tests/test_torch_parallel_modes.py``: the eleven
training modes other than ``cps`` at tiny size (each mode's shipped config
cut to resnet18, K=8 where it has codebooks, 64x64, global batch 4 + 4),
their states, steps and per-step draws in f64, built alike in a single process
and on every rank of a mesh.  Imports torch, numpy and the port only: the
gloo workers (``tests/_torch_dist_worker.py``) import it.
"""
import contextlib
import json
import os
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))
HW, B = 64, 4
NUM_EMB = [0, 0, 8, 8, 8]
DROP_PERCENT, ANGULAR_TH = 80.0, 0.5
UNIMATCH_PARAMS = {"encoder_name": "resnet18", "num_classes": 3, "depth": 5}
# the head's kernel 150 times its drawn scale makes the eval-mode teacher
# confident (softmax above 0.95) on part of the pixels, so that the three
# unlabeled terms are not 0 (``tests/test_torch_unimatch.py``)
UNIMATCH_HEAD_SCALE = 150.0
# mode -> its shipped config.  Every step runs in f64: in f32 the encoder's
# BatchNorm gradients at these shapes are sums that nearly cancel, and any
# two summation orders (sync-BN's against the single process's BatchNorm,
# or f32 against f64) move them by about 1e-2 relative, as PERF.md records
# for the flagship; in f64 a DP step lies within about 1e-13 of the single
# process, so the bounds below test the semantics
MODES = {
    "sup": "only_sup_kmeans",
    "reptcps": "vqreptunet1x1",
    "plaincps": "cps_vqv2",
    "objcps": "vqcanet_obj_loss",
    "vqpt": "vq_pt_unet",
    "easyhard": "vq_pt_unet_easyhard",
    "angularv3": "vqreptunetangularv3",
    "supconcps": "sup_con_loss",
    "semiweed": "semiweednet",
    "unimatch": "semiweednet",
    "salientcps": "vqreptunet1x1v2",
}
DTYPE = torch.float64
SINGLE_MODEL = ("sup", "semiweed", "unimatch")


def tiny_cfg(mode: str, batch_size: int = B):
    """The mode's config cut to size, as the port's ``Config``."""
    from vq_seg_tpu_torch.config import Config

    cfg = json.load(open(os.path.join(ROOT, "config", f"{MODES[mode]}.json")))
    cfg.update(resize=HW, mode=mode, wandb_logging=False)
    params = cfg["model"]["params"]
    params["encoder_name"] = "resnet18"
    params.pop("encoder_weights", None)
    if "vq_cfg" in params:
        params["vq_cfg"]["num_embeddings"] = NUM_EMB
    cfg["train"].update(batch_size=batch_size, num_epochs=1, overlap_size=24)
    if mode == "unimatch":
        cfg["model"] = {"name": "unimatch", "params": dict(UNIMATCH_PARAMS)}
        cfg["train"]["criterion"] = {"name": "cross_entropy"}
    if mode == "salientcps":
        cfg["model"] = {"name": "VQUnetwithSalientloss",
                        "params": {k: params[k] for k in ("encoder_name", "num_classes",
                                                          "vq_cfg")}}
    return Config(cfg)


def global_batch(seed: int = 0, n: int = B):
    """(l_img, l_target, ul_img, l_sal, ul_sal): NCHW f32 images, (n, H, W)
    int64 labels in {0, 1, 2}, (n, H, W) saliency maps in [0, 1]."""
    rng = np.random.default_rng(seed)
    img = lambda: torch.from_numpy(rng.standard_normal((n, 3, HW, HW)).astype(np.float32))
    l_img = img()
    l_t = torch.from_numpy(rng.integers(0, 3, (n, HW, HW)).astype(np.int64))
    ul = img()
    sal = lambda: torch.from_numpy(rng.uniform(size=(n, HW, HW)).astype(np.float32))
    return l_img, l_t, ul, sal(), sal()


@contextlib.contextmanager
def port_f64(on: bool = True):
    """``Tensor.float()`` leaves f64 tensors as they are inside the block,
    so that a port module cast to f64 stays f64 where it pins f32."""
    if not on:
        yield
        return
    f32 = torch.Tensor.float
    with mock.patch.object(torch.Tensor, "float",
                           lambda t: t if t.dtype == torch.float64 else f32(t)):
        yield


def models_of(state) -> list:
    """(index, model) of each model the state holds."""
    if hasattr(state, "held"):
        return [(i, m) for i, m, _ in state.held()]
    return [(0, state.model)]


def make_state(mode: str, cfg, batch, mesh=None, start=None):
    """The mode's driver state (seed 0, a constant LR) after its init phase
    on the global ``batch``, on every rank alike, then cast to f64.
    ``start``: state dicts by model index to load before the init phase
    (``unimatch``: the JAX package's seeded variables)."""
    from vq_seg_tpu_torch.training import supervised, variant_drivers as vd
    from vq_seg_tpu_torch.training.cps import cps_init_phase

    schedule = lambda step: 1e-3  # noqa: E731
    l_img, l_t = batch[0], batch[1]
    if mode in SINGLE_MODEL:
        model_cfg = cfg.model if mode != "sup" else vd.model_cfg_with_bn(cfg)
        state = supervised.create_state(model_cfg, schedule, device="cpu", mesh=mesh)
    else:
        state = vd.dual_state(cfg, schedule, "cpu", mesh)
    for i, model in models_of(state):
        if start is not None:
            model.load_state_dict(start[i])
    if mode == "sup":
        fwd = supervised.sup_forward_mode(cfg.model.name)
        supervised.init_phase(state, supervised.forward_args(fwd, l_img, l_t, DROP_PERCENT))
    elif mode == "reptcps":
        cps_init_phase(state, l_img, l_t, 100.0)
    elif mode in ("plaincps", "objcps", "salientcps"):
        vd.plain_init_phase(state, l_img, l_t)
    elif mode in ("vqpt", "easyhard"):
        vd.vqpt_init_phase(state, l_img, l_t)
    elif mode == "angularv3":
        vd.vqpt_init_phase(state, l_img, l_t, extra=("labeled", 0.0))
    elif mode == "supconcps":
        vd.vqpt_init_phase(state, l_img, l_t, extra=("label",), init_protos=False)
    if mode == "unimatch":  # the teacher confident on part of the batch (UNIMATCH_HEAD_SCALE)
        with torch.no_grad():
            state.model.segmentation_head.conv.weight.mul_(UNIMATCH_HEAD_SCALE)
    for _, model in models_of(state):
        model.to(DTYPE)
    return state


def make_step(mode: str, cfg, state, mesh=None):
    """The mode's step as its driver builds it (``plaincps`` also sets the
    optimizers, as its driver does)."""
    from vq_seg_tpu_torch.losses import make_loss
    from vq_seg_tpu_torch.training import supervised, variant_drivers as vd
    from vq_seg_tpu_torch.training import variants

    tc = cfg.train
    crit = make_loss(tc.criterion.name, cfg.num_classes, ignore_index=255,
                     weight=tc.criterion.get("weight"))
    if mode == "sup":
        return supervised.make_sup_train_step(
            crit, num_classes=cfg.num_classes, ce_weight=tc.criterion.get("weight"),
            forward_mode=supervised.sup_forward_mode(cfg.model.name), mesh=mesh)
    if mode == "reptcps":
        return variants.make_rept_cps_train_step(
            crit, num_classes=cfg.num_classes, cps_loss_weight=tc.get("cps_loss_weight", 1.0),
            commitment_loss_weight=tc.get("total_commitment_loss_weight", 1.0),
            prototype_loss_weight=tc.get("total_prototype_loss_weight", 0.01), mesh=mesh)
    if mode in ("plaincps", "objcps"):
        return vd.plain_step(cfg, state, mode, mesh)
    if mode in ("vqpt", "easyhard", "angularv3", "supconcps"):
        return vd.vqpt_step(cfg, mode, mesh)
    if mode == "semiweed":
        return variants.make_semiweed_train_step(
            crit, num_classes=cfg.num_classes, overlap_size=tc.overlap_size,
            ce_loss_weight=tc.get("ce_loss_weight", 1.0),
            dc_loss_weight=tc.get("dc_loss_weight", 1.0), mesh=mesh)
    if mode == "unimatch":
        return variants.make_unimatch_train_step(
            num_classes=cfg.num_classes, confidence_threshold=tc.get("confidence_threshold", 0.95),
            ce_weight=tc.criterion.get("weight"), mesh=mesh)
    return vd.salient_step(cfg, mesh)


def run_step(mode: str, cfg, state, step, batch, mesh=None, masks=None):
    """One step of ``mode`` on this rank's shard of the global ``batch``
    (all of it without a mesh), in f64, with the driver's own
    per-step draws (drawn for the global batch, this rank's rows).
    ``unimatch`` takes ``masks`` = (box 1, box 2, ASPP keep by global
    shape, the perturbation's two keeps) where given.  Returns the
    metrics."""
    from vq_seg_tpu_torch.parallel.mesh import shard_batch_fn, shard_draw
    from vq_seg_tpu_torch.training import variant_drivers as vd

    dtype = DTYPE
    shard = shard_batch_fn(mesh) if mesh is not None else (lambda x: x)
    rows = batch[0].shape[0] // (1 if mesh is None else mesh.n_data)
    l_img, l_t, ul, l_sal, ul_sal = (shard(x) for x in batch)
    l_img, ul, l_sal, ul_sal = (x.to(dtype) for x in (l_img, ul, l_sal, ul_sal))
    with port_f64(dtype == torch.float64):
        if mode == "sup":  # vqunet_v2 takes no dropout
            return step(state, l_img, l_t, DROP_PERCENT)[1]
        if mode == "reptcps":
            return step(state, l_img, l_t, ul, DROP_PERCENT)[1]
        if mode == "easyhard":
            return step(state, l_img, l_t, ul, *vd.easyhard_draws(cfg, "cpu")((HW, HW)))[1]
        if mode == "angularv3":
            return step(state, l_img, l_t, ul, ANGULAR_TH)[1]
        if mode == "semiweed":
            case1, case2, keeps = vd.semiweed_draws(cfg, "cpu")()
            return step(state, l_img, l_t, ul, case1, case2,
                        tuple(shard_draw(k, mesh, rows) for k in keeps))[1]
        if mode == "unimatch":
            if masks is None:
                box_1, box_2, dropout, fp = vd.unimatch_draws(cfg, "cpu")((HW, HW))
            else:
                box_1, box_2, by_shape, fps = masks
                fps = list(fps)
                dropout = lambda shape: by_shape[tuple(shape)]  # noqa: E731
                fp = lambda shape: fps.pop(0)  # noqa: E731
            return step(state, l_img, l_t, ul, box_1, box_2, shard_draw(dropout, mesh, rows),
                        shard_draw(fp, mesh, rows))[1]
        if mode == "salientcps":
            return step(state, l_img, l_t, l_sal, ul, ul_sal)[1]
        return step(state, l_img, l_t, ul)[1]


def snapshot(state) -> dict:
    """The step's outcome: gradients, BN running statistics and parameters,
    by ``i.name``."""
    out = {"grads": {}, "running": {}, "params": {}}
    for i, model in models_of(state):
        for n, p in model.named_parameters():
            out["params"][f"{i}.{n}"] = p.detach().clone()
            if p.grad is not None:
                out["grads"][f"{i}.{n}"] = p.grad.detach().clone()
        for n, b in model.named_buffers():
            if "running" in n:
                out["running"][f"{i}.{n}"] = b.detach().clone()
    return out


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def compare(metrics: dict, snap: dict, want_metrics: dict, want: dict) -> dict:
    """The largest distances of a step's outcome from the single process's:
    loss terms (relative), IoUs, gradients (relative L2 by tensor) and
    running statistics (relative L2), and the tensors compared."""
    scalar = [k for k, v in want_metrics.items() if v.numel() == 1 and k != "miou"]
    return {
        "keys": (sorted(metrics) == sorted(want_metrics),
                 sorted(snap["grads"]) == sorted(want["grads"]),
                 sorted(snap["running"]) == sorted(want["running"])),
        "loss": max(abs(float(metrics[k]) - float(want_metrics[k]))
                    / max(abs(float(want_metrics[k])), 1e-12) for k in scalar),
        "iou": max(float((metrics[k].double() - want_metrics[k].double()).abs().max())
                   for k in ("miou", "iou_list")),
        "grads": max(rel(g, want["grads"][k]) for k, g in snap["grads"].items()),
        "worst": sorted(((rel(g, want["grads"][k]), k) for k, g in snap["grads"].items()),
                        reverse=True)[:3],
        "running": max(rel(b, want["running"][k]) for k, b in snap["running"].items()),
        "n_grads": len(snap["grads"]), "n_running": len(snap["running"]),
        "terms": scalar,
    }


def param_digest(state) -> bytes:
    """A digest of every parameter's bytes: equal digests are bitwise equal
    parameters."""
    import hashlib

    h = hashlib.sha256()
    for _, model in models_of(state):
        for _, p in sorted(model.named_parameters()):
            h.update(p.detach().contiguous().cpu().numpy().tobytes())
    return h.digest()
