"""Generate videos with the port (the serving path; twin of
``scripts/generate.py``).

  python -m ganode_tpu_torch.generate --config ucf_ode --num 64 --out v.npz \
      [--weights gen.pt] [--set FIELD=VALUE ...] [--video-len 32] [--cpu]

Writes an .npz of videos ``(N, T, H, W, C)`` in [-1, 1] to ``--out``; without
``--out`` nothing is written. ``--weights`` loads a port ``state_dict`` (for
instance one written from JAX variables by ``ganode_tpu_torch.bridge``);
without it the generator runs on its seeded initial weights. Runs on the CUDA
card unless ``--cpu`` is given; with no card and no ``--cpu`` it exits with an
error. ``--int8`` and ``--gif`` wait for ROADMAP M16 and M18.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import resolve_device
from .compat import GeneratorSession
from .models import generator_for_config
from .utils import layout
from .utils.config import get_config, overrides_from_strings


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m ganode_tpu_torch.generate")
    p.add_argument("--config", required=True)
    p.add_argument("--num", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--video-len", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help=".npz output path")
    p.add_argument("--weights", default=None,
                   help="port state_dict (.pt) to load into the generator")
    p.add_argument("--set", dest="sets", action="append", default=[],
                   metavar="FIELD=VALUE", help="config overrides")
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

    gen = generator_for_config(config, device=device)
    state_dict = None
    if args.weights:
        state_dict = torch.load(args.weights, map_location="cpu",
                                weights_only=True)
        print(f"loaded {args.weights}")
    else:
        print("WARNING: no checkpoint — generating from the initial model")
    sess = GeneratorSession(gen, state_dict, seed=args.seed, device=device)

    videos = []
    for j in range(0, args.num, args.batch_size):
        n = min(args.batch_size, args.num - j)
        v, _ = sess.sample_videos(n, args.video_len)
        videos.append(layout.video_from_torch(v).cpu().numpy())
    videos = np.concatenate(videos)
    print(f"generated {videos.shape} in [{videos.min():.3f}, "
          f"{videos.max():.3f}] on {device}")
    if args.out:
        np.savez_compressed(args.out, videos=videos)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
