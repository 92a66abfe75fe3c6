"""CLI trainer, the port's ``scripts/train.py``::

    python -m vq_seg_tpu_torch.train --config_path config/vqreptunet1x1v2.json

Runs on the card unless ``--device cpu`` is given.  The mode defaults to
the config's ``"mode"`` key, else ``cps``.  Ported: ``cps`` (the
flagship), ``reptcps`` (``config/vqreptunet1x1.json`` and its siblings),
``sup`` (``config/CWFID_Unet.json``, ``only_sup_kmeans.json``...),
``plaincps`` (``config/cps_vqv2*.json``, ``vqcanet.json``,
``vqatunet.json`` and the other attention networks), ``objcps``
(``config/vqcanet_obj_loss.json``, ``vqimdbnet.json``), ``vqpt``
(``config/vq_pt_unet.json``, ``vq_eu_pt_unet.json``, ``vq_nedpt_unet.json``,
``vqash.json``, ``vqash_deep.json``, ``vqashv2.json``), ``easyhard``
(``config/vq_pt_unet_easyhard.json``), ``angularv3``
(``config/vqreptunetangularv3.json``; ``vqreptunetangular.json`` trains
under ``reptcps``), ``supconcps`` (``config/sup_con_loss.json``),
``semiweed`` (``config/semiweednet.json``), ``selfsup``
(``config/vqvaev2_selfsup.json``), ``unimatch`` (the ``unimatch`` network;
no shipped config) and ``salientcps`` (``VQUnetwithSalientloss`` with
``train.salient_dir``; no shipped config): every mode of the JAX CLI, and
``sup`` also runs ``config/obia_CWFID.json`` (fcn32s on an OBIA tree), so
all 41 shipped configs train.  The JAX CLI's parallelism flags and
``--trace`` are not offered.
"""
from __future__ import annotations

import argparse

from .config import load_config

MODES = ("cps", "sup", "selfsup", "plaincps", "unimatch", "salientcps", "vqpt", "reptcps",
         "angularv3", "easyhard", "objcps", "supconcps", "semiweed")
PORTED = MODES  # every mode of the JAX CLI trains here


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("::")[0])
    parser.add_argument("--config_path", default="./config/vqreptunet1x1v2.json")
    parser.add_argument("--mode", default=None, choices=MODES,
                        help='trainer family; defaults to the config\'s "mode" key, else cps')
    parser.add_argument("--max_steps_per_epoch", type=int, default=None)
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    opt = parser.parse_args(argv)
    cfg = load_config(opt.config_path)
    mode = opt.mode or cfg.get("mode") or "cps"
    from . import training

    trainer = {"cps": training.train, "reptcps": training.train_rept_cps,
               "sup": training.train_sup, "plaincps": training.train_plain_cps,
               "objcps": training.train_obj_cps, "vqpt": training.train_vqpt_cps,
               "easyhard": training.train_easyhard_cps,
               "angularv3": training.train_angularv3_cps,
               "supconcps": training.train_supcon_cps, "semiweed": training.train_semiweed,
               "selfsup": training.train_selfsup, "unimatch": training.train_unimatch,
               "salientcps": training.train_salient_cps}[mode]
    trainer(cfg, max_steps_per_epoch=opt.max_steps_per_epoch, device=opt.device)


if __name__ == "__main__":
    main()
