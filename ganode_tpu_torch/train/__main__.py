"""Train any ported config by name (twin of ``scripts/train.py``):

  python -m ganode_tpu_torch.train --config mnist_ode --data data/rot-mnist.npz \
      --workdir runs/mnist_ode
  python -m ganode_tpu_torch.train --config ucf_ode --data data/ucf101-pack ...
  python -m ganode_tpu_torch.train --config mnist_ode --synthetic --steps 3

Runs on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it exits with an error. ``--resume`` continues from the workdir's
latest checkpoint.

``--mesh data=N`` (or ``data=N,seq=M``) trains over N (N x M) ranks, one
process each, launched by ``torch.distributed.run``:

  python -m torch.distributed.run --nproc-per-node 2 -m ganode_tpu_torch.train \
      --config ucf_ode --synthetic --mesh data=2

Each rank joins the process group from the launcher's environment over
``--backend`` (``nccl``, a card per rank, by default; ``gloo`` for the CPU
or for more ranks than cards) and runs the loop; rank 0 writes the run's
files (``train/runner.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from .. import resolve_device
from ..utils.config import get_config, overrides_from_strings
from .runner import run_training


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m ganode_tpu_torch.train")
    p.add_argument("--config", required=True)
    p.add_argument("--workdir", default=None)
    p.add_argument("--data", default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="run on synthetic data (smoke/dry-run mode)")
    p.add_argument("--mesh", default=None,
                   help="'data=N' or 'data=N,seq=M': the step over the ranks "
                        "of torch.distributed.run")
    p.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                   help="the process group's transport with --mesh (gloo for "
                        "the CPU or more ranks than cards)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--set", dest="sets", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="override any ExperimentConfig field, typed from the "
                        "dataclass (e.g. --set ngf=8 --set ema_decay=0.999); "
                        "repeatable")
    args = p.parse_args(argv)
    if args.mesh and "WORLD_SIZE" not in os.environ:
        p.error(f"--mesh {args.mesh}: launch under python -m "
                "torch.distributed.run, which gives each rank its process group")

    overrides = {}
    if args.data:
        overrides["data_path"] = args.data
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    try:
        overrides.update(overrides_from_strings(args.sets))
    except ValueError as e:
        p.error(f"--set {e}")
    if args.mesh:
        overrides["mesh"] = args.mesh
    config = get_config(args.config, **overrides)
    try:
        device = resolve_device("cpu" if args.cpu else "cuda")
        if args.mesh:
            from ..parallel import init_distributed

            device = init_distributed(args.backend, device)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"error: {e}")

    workdir = args.workdir or os.path.join("runs", config.name)
    print(f"config: {dataclasses.asdict(config)}")
    try:
        state, metrics = run_training(
            config, workdir, steps=args.steps, synthetic=args.synthetic,
            resume=args.resume, device=device)
    finally:
        if args.mesh:
            import torch.distributed as dist

            dist.destroy_process_group()
    if "preempted" in metrics:
        print(f"preempted at step {state.step} (checkpointed); "
              f"rerun with --resume to continue bit for bit")
    else:
        print(f"done at step {state.step}: {metrics}")


if __name__ == "__main__":
    main()
