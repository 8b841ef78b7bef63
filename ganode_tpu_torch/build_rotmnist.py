"""Build the rotated-MNIST video dataset (twin of ``scripts/build_rotmnist.py``,
the reference's utils/images.py offline preparation):

  python -m ganode_tpu_torch.build_rotmnist --out data/rot-mnist.npz --mnist-dir data/mnist
  python -m ganode_tpu_torch.build_rotmnist --out data/rot-mnist.npz --synthetic
  python -m ganode_tpu_torch.build_rotmnist --out data/rot-mnist.npz --sklearn
  python -m ganode_tpu_torch.build_rotmnist --out data/rot-mnist-3s.npz --digits 3 ...

Reads raw MNIST idx ``.gz`` files from ``--mnist-dir``, scikit-learn's
bundled handwritten digits (``--sklearn``: 1797 8x8 scans upscaled to
28x28), or procedural squares (``--synthetic``). The ``.npz`` it writes
holds the same ``X`` and ``Y`` as the JAX package's script for the same
input and flags. Needs no card.
"""
from __future__ import annotations

import argparse

from .data.rotmnist import (build_rotmnist, load_mnist_idx,
                            load_sklearn_digits, synthetic_digits)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m ganode_tpu_torch.build_rotmnist")
    p.add_argument("--out", required=True)
    p.add_argument("--mnist-dir", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--sklearn", action="store_true",
                   help="use scikit-learn's bundled handwritten digits")
    p.add_argument("--num", type=int, default=11000,
                   help="number of digits (reference uses 10k train + 1k valid)")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--mode", default="normal",
                   choices=["normal", "rand-end", "rsre"])
    p.add_argument("--digits", type=int, nargs="*", default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.sklearn:
        images, labels = load_sklearn_digits(args.num, seed=args.seed)
    elif args.synthetic:
        images, labels = synthetic_digits(args.num, seed=args.seed)
    else:
        if not args.mnist_dir:
            p.error("--mnist-dir required unless --synthetic")
        images, labels = load_mnist_idx(args.mnist_dir, "train", args.num)

    digits = tuple(args.digits) if args.digits else None
    out = build_rotmnist(args.out, images, labels, num_frames=args.frames,
                         mode=args.mode, seed=args.seed, digits=digits)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
