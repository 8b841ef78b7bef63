"""Convert a reference (chechaohp/gan-ode) torch checkpoint into a port
training run (twin of ``scripts/import_reference_checkpoint.py``).

    python -m ganode_tpu_torch.import_reference \
        --ckpt /path/state_normal41000.ckpt --config mnist_ode --workdir RUN \
        [--set FIELD=VALUE ...] [--fresh-optimizer] [--cpu]

It builds the config's trainer (on the CUDA card unless ``--cpu``; with no
card and no ``--cpu`` it exits with an error), maps the checkpoint's three
state_dicts into its state (``compat_torch.import_gan_state``) and saves
that state as a port checkpoint, ``RUN/checkpoints/<step>/state.pt``, the
step being the reference 'epoch' (== G-steps). Every port command then reads
it: ``python -m ganode_tpu_torch.generate --workdir RUN``, ``python -m
ganode_tpu_torch.evaluate --workdir RUN`` and ``python -m
ganode_tpu_torch.train --workdir RUN --resume``, with the same ``--set``
overrides, which must give the reference model's sizes.

The reference's torch Adam moments are imported when the checkpoint carries
them, so fine-tuning continues with its optimizer statistics;
``--fresh-optimizer`` restarts Adam from zero moments instead.
"""
from __future__ import annotations

import argparse
import os
import sys

from . import resolve_device
from .compat_torch import import_gan_state, load_reference_checkpoint
from .train.runner import build_trainer
from .utils.checkpoint import CheckpointManager
from .utils.config import get_config, overrides_from_strings


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m ganode_tpu_torch.import_reference")
    p.add_argument("--ckpt", required=True,
                   help="reference state_normal{epoch}.ckpt (torch.save dict)")
    p.add_argument("--config", default="mnist_ode",
                   help="config matching the checkpoint's architecture")
    p.add_argument("--workdir", required=True,
                   help="output run directory (checkpoint lands under "
                        "<workdir>/checkpoints)")
    p.add_argument("--set", dest="sets", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="config overrides, e.g. --set ngf=64 --set ndf=64 "
                        "(must match the reference model's sizes)")
    p.add_argument("--fresh-optimizer", action="store_true",
                   help="skip the torch Adam moments; fine-tuning then "
                        "restarts Adam from zero-initialized moments")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)

    try:
        overrides = overrides_from_strings(args.sets)
    except ValueError as e:
        p.error(f"--set {e}")
    config = get_config(args.config, **overrides)
    try:
        device = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        sys.exit(f"error: {e}")

    ckpt = load_reference_checkpoint(args.ckpt)
    state = build_trainer(config, device=device).init_state()
    state = import_gan_state(ckpt, state, config,
                             import_optimizer=not args.fresh_optimizer)
    directory = os.path.join(args.workdir, "checkpoints")
    CheckpointManager(directory).save(state.step, state)
    print(f"imported reference step {state.step} -> {directory}")


if __name__ == "__main__":
    main()
