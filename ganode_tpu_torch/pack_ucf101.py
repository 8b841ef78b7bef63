"""Pack a UCF101 split once, offline (twin of ``scripts/pack_ucf101.py``):
decode, bicubic resize to (64, 85), crop 64x64, and write the uint8 pack
that the samplers and the native loader read.

  python -m ganode_tpu_torch.pack_ucf101 --root /data/ucf101 \
      --out data/ucf101-pack [--video-folder videos \
      --annotation-folder annotations --fold 1 --test --image-size 64 \
      --n-frame 16 --max-videos N --target-fps F]

CPU work: it needs OpenCV (``cv2``) and no card.
"""
from __future__ import annotations

import argparse

from .data.ucf101 import pack_ucf101


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m ganode_tpu_torch.pack_ucf101")
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--video-folder", default="videos")
    p.add_argument("--annotation-folder", default="annotations")
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--test", action="store_true", help="pack the test split")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--n-frame", type=int, default=16)
    p.add_argument("--max-videos", type=int, default=None)
    p.add_argument("--target-fps", type=float, default=None,
                   help="resample every video to this frame rate at pack time")
    args = p.parse_args(argv)

    out = pack_ucf101(
        args.root, args.out,
        video_folder=args.video_folder,
        annotation_folder=args.annotation_folder,
        train=not args.test, fold=args.fold,
        n_frame=args.n_frame, image_size=args.image_size,
        target_fps=args.target_fps, max_videos=args.max_videos,
    )
    print(f"packed to {out}")


if __name__ == "__main__":
    main()
