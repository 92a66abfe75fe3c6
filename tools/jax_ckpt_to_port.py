"""Turn the JAX package's checkpoints into the PyTorch port's.

The JAX package writes each ``.ckpt`` as an orbax directory holding
``{model_1, model_2, epoch, batch_idx, optimizer_1, optimizer_2}`` (or the
models, epoch and batch_idx alone for a light snapshot); the port reads the
same contract as one ``torch.save`` file (``vq_seg_tpu_torch/utils/
ckpoints.py``), which its test CLI, ``Predictor.from_checkpoint`` and the
CPS driver's resume take::

    python tools/jax_ckpt_to_port.py --config_path config/vqreptunet1x1v2.json \\
        --src runs/CWFID/VQRePTUnet1x1v2_hybrid_0/ckpoints --dst port_runs/ckpoints

``--src`` is one ``.ckpt`` or a directory whose ``*.ckpt`` are converted
one for one into ``--dst`` (a file or a directory).  The models map with
``state_dict_from_flax``.  Adam's moments ``mu``/``nu`` map under the same
parameter names into torch Adam's ``exp_avg``/``exp_avg_sq`` and its
``count`` into every parameter's ``step``, so that the port resumes at the
JAX run's update count and LR; under ``optax.MultiSteps``
(``train.grad_accum_steps``) the running mean ``acc_grads`` and
``mini_step`` go into the port's ``MultiStepAdam`` state as well.  Runs on
the CPU; imports both packages.
"""
from __future__ import annotations

import argparse
import os
import sys
from glob import glob

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from vq_seg_tpu.utils.ckpoints import load_full as jax_load_full  # noqa: E402
from vq_seg_tpu_torch.config import load_config  # noqa: E402
from vq_seg_tpu_torch.models.networks import make_model  # noqa: E402
from vq_seg_tpu_torch.training.cps import _adam  # noqa: E402
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax  # noqa: E402


def _num_embeddings(model_cfg):
    vq_cfg = model_cfg["params"].get("vq_cfg") or {}
    return vq_cfg.get("num_embeddings")


def _adam_state(opt):
    """(the ``scale_by_adam`` state ``{count, mu, nu}``, the MultiSteps
    state or None) of an orbax-restored optax state."""
    if isinstance(opt, dict) and "inner_opt_state" in opt:
        inner, multi = opt["inner_opt_state"], opt
    else:
        inner, multi = opt, None
    adam = next(s for s in inner if isinstance(s, dict) and "mu" in s)
    return adam, multi


def optimizer_state_dict(opt, variables, model, model_cfg) -> dict:
    """A JAX optimizer state (orbax-restored plain containers) of one model
    -> the port's Adam ``state_dict`` for ``model``'s parameters (with
    ``mini_step`` and ``acc_grads`` under gradient accumulation)."""
    adam, multi = _adam_state(opt)
    sd = _adam(model.parameters()).state_dict()
    num_emb = _num_embeddings(model_cfg)
    names = [n for n, _ in model.named_parameters()]

    def by_index(tree):
        mapped = state_dict_from_flax({**variables, "params": tree}, num_emb)
        return {i: mapped[n].clone() for i, n in enumerate(names)}

    count = int(np.asarray(adam["count"]))
    if count > 0:  # a fresh torch Adam holds no per-parameter state
        mu, nu = by_index(adam["mu"]), by_index(adam["nu"])
        sd["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[i],
                           "exp_avg_sq": nu[i]} for i in range(len(names))}
    if multi is not None:
        sd["mini_step"] = int(np.asarray(multi["mini_step"]))
        sd["acc_grads"] = by_index(multi["acc_grads"])
    return sd


def convert_tree(ck: dict, model_cfg) -> dict:
    """One restored JAX contract -> the port's."""
    num_emb = _num_embeddings(model_cfg)
    out = {"epoch": int(np.asarray(ck["epoch"]))}
    if "batch_idx" in ck:
        out["batch_idx"] = int(np.asarray(ck["batch_idx"]))
    for i in (1, 2):
        if f"model_{i}" in ck:
            out[f"model_{i}"] = state_dict_from_flax(ck[f"model_{i}"], num_emb)
    if ck.get("optimizer_1") is not None:
        model = make_model(model_cfg, device="cpu")
        for i in (1, 2):
            out[f"optimizer_{i}"] = optimizer_state_dict(ck[f"optimizer_{i}"], ck[f"model_{i}"],
                                                         model, model_cfg)
    return out


def convert_file(src: str, dst: str, model_cfg) -> dict:
    """Convert the orbax checkpoint ``src`` and ``torch.save`` it at
    ``dst`` (written under a temporary name, then renamed)."""
    tree = convert_tree(jax_load_full(src), model_cfg)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    tmp = f"{dst}.tmp{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, dst)
    return tree


def convert(src: str, dst: str, model_cfg) -> list:
    """``src`` one ``.ckpt`` (``dst`` the file to write) or a directory of
    them (``dst`` the directory to write ``*.ckpt`` into).  Returns the
    files written."""
    if os.path.exists(os.path.join(src, "_METADATA")):  # one orbax checkpoint
        convert_file(src, dst, model_cfg)
        return [dst]
    written = []
    for path in sorted(glob(os.path.join(src, "*.ckpt"))):
        out = os.path.join(dst, os.path.basename(path))
        convert_file(path, out, model_cfg)
        written.append(out)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("::")[0])
    ap.add_argument("--config_path", required=True, help="the run's config (its model)")
    ap.add_argument("--src", required=True, help="a JAX .ckpt or a directory of them")
    ap.add_argument("--dst", required=True, help="the port's .ckpt or a directory for them")
    opt = ap.parse_args(argv)
    for path in convert(opt.src, opt.dst, load_config(opt.config_path).model):
        print(path)


if __name__ == "__main__":
    main()
