"""Write the labelled synthetic UCF101 stand-in corpus and, asked, pack it
(twin of ``scripts/make_synthetic_ucf101.py``): MJPG .avi clips of 320x240
of moving coloured squares in the reference's directory layout
(``data/synthetic.py``), then the real offline pack over them (cv2 decode,
bicubic resize to (64, 85), crop x[10:74]; ``data/ucf101.py``).

  python -m ganode_tpu_torch.make_synthetic_ucf101 --root data/synth-ucf \
      --pack-out data/synth-ucf-pack --n-videos 2048

CPU work: it needs OpenCV (``cv2``) and no card.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from .data.synthetic import write_corpus
from .data.ucf101 import pack_ucf101


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m ganode_tpu_torch.make_synthetic_ucf101")
    p.add_argument("--root", required=True,
                   help="corpus root (videos/ + annotations/)")
    p.add_argument("--pack-out", default=None,
                   help="also run pack_ucf101 into this directory")
    p.add_argument("--n-videos", type=int, default=2048)
    p.add_argument("--min-frames", type=int, default=32)
    p.add_argument("--max-frames", type=int, default=64)
    p.add_argument("--fps", type=float, default=25.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image-size", type=int, default=64)
    args = p.parse_args(argv)

    t0 = time.time()
    train_paths, _ = write_corpus(
        args.root, args.n_videos, min_frames=args.min_frames,
        max_frames=args.max_frames, fps=args.fps, seed=args.seed,
        progress=True)
    print(f"encoded {args.n_videos} videos ({len(train_paths)} train) "
          f"in {time.time() - t0:.0f}s")

    if args.pack_out:
        t0 = time.time()
        pack_ucf101(args.root, args.pack_out, image_size=args.image_size)
        t_pack = time.time() - t0
        with open(os.path.join(args.pack_out, "meta.json")) as f:
            meta = json.load(f)
        print(f"packed {len(meta['paths'])} videos / "
              f"{meta['total_frames']} frames in {t_pack:.0f}s "
              f"-> {args.pack_out}")


if __name__ == "__main__":
    main()
