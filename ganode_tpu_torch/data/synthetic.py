"""A labelled synthetic video corpus at UCF101's own geometry (twin of
``ganode_tpu/data/synthetic.py``).

It stands in for UCF101 where the dataset is not at hand: clips of 320x240
and varying length of a coloured square moving along a line, the clip's
generative factors its class. ``write_corpus`` writes them as MJPG .avi
files in the reference's layout (videos/<Class>/v_<Class>_g01_cNN.avi,
annotations/classInd.txt and {train,test}list01.txt; reference
dataset/ucf101new.py:35-68), so that the real offline pack
(``data/ucf101.py::pack_ucf101``: cv2 decode, bicubic resize to (64, 85),
crop x[10:74]; reference dataset/ucf101new.py:31,73-78) runs end to end.

The labels follow ``data/shapes.py::synthetic_moving_shapes``, so the eval
assets (a classifier on label % 8, an embedder on the label) transfer:
label = direction octant * 8 + colour octant, the direction octant binning
the motion (dx, dy) into 8 compass directions (seen only across frames) and
the colour octant thresholding each RGB channel at 0.6 (seen in a frame).
Channel values are drawn outside (0.55, 0.65), so that MJPG's quantization
cannot flip a colour bit.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

# octant index -> compass name, in the order arctan2(dy, dx)/(pi/4) rounds to
# (y grows downward in image coordinates, but the bin IDENTITY only has to be
# stable, not geographically accurate)
DIRECTIONS = ("E", "NE", "N", "NW", "W", "SW", "S", "SE")
# color octant = (r>0.6)*4 + (g>0.6)*2 + (b>0.6)*1
COLORS = ("Dark", "Blue", "Green", "Cyan", "Red", "Magenta", "Yellow", "White")

# native UCF101 frame geometry (320x240); the pack path's resize(64,85) +
# crop x[10:74] maps back to source x in [37.6, 278.6], so motion is confined
# to a margin inside that window to keep every factor decodable post-crop
WIDTH, HEIGHT = 320, 240
_X_SAFE = (48, 272)   # inclusive box for the square's x extent
_Y_SAFE = (8, 232)


def class_name(label: int) -> str:
    return f"Move{DIRECTIONS[label // 8]}{COLORS[label % 8]}"


def _draw_color(rng: np.random.RandomState) -> np.ndarray:
    """uniform(0.2, 1.0) per channel, resampled out of the (0.55, 0.65) band
    around the 0.6 class threshold (keeps labels MJPG-robust)."""
    color = np.empty(3)
    for c in range(3):
        v = rng.uniform(0.2, 1.0)
        while 0.55 < v < 0.65:
            v = rng.uniform(0.2, 1.0)
        color[c] = v
    return color


def moving_square_video(
    rng: np.random.RandomState, n_frames: int,
) -> Tuple[np.ndarray, int]:
    """One (n_frames, 240, 320, 3) uint8 clip + its factor label.

    Scaled-up twin of data/shapes.py::synthetic_moving_shapes at 64px: a 45px
    square (12px * 240/64) moving (dx, dy) in [-8, 8] px/frame ([-2, 2]
    post-resize), clamped to the crop-safe box.
    """
    side = 45
    video = np.zeros((n_frames, HEIGHT, WIDTH, 3), np.uint8)
    color = _draw_color(rng)
    # the in-memory twin (data/shapes.py) stores the square AS `color` in [-1, 1] space
    # (background -1); the pack path normalizes uint8 via (x - 128) / 128, so
    # encode (color + 1) * 127.5 to land on the same post-normalize values the
    # persisted eval assets were trained on
    rgb = np.round((color + 1.0) * 127.5).astype(np.uint8)
    x0 = rng.randint(_X_SAFE[0], _X_SAFE[1] - side)
    y0 = rng.randint(_Y_SAFE[0], _Y_SAFE[1] - side)
    dx, dy = 0, 0
    while dx == 0 and dy == 0:
        dx, dy = rng.randint(-8, 9, 2)
    for t in range(n_frames):
        x = int(np.clip(x0 + dx * t, _X_SAFE[0], _X_SAFE[1] - side))
        y = int(np.clip(y0 + dy * t, _Y_SAFE[0], _Y_SAFE[1] - side))
        video[t, y:y + side, x:x + side, :] = rgb
    octant = int(np.round(np.arctan2(dy, dx) / (np.pi / 4))) % 8
    color_bucket = int((color > 0.6) @ np.array([4, 2, 1]))
    return video, octant * 8 + color_bucket


def write_corpus(
    root: str,
    n_videos: int = 2048,
    *,
    min_frames: int = 32,
    max_frames: int = 64,
    fps: float = 25.0,
    seed: int = 0,
    test_every: int = 8,
    progress: bool = False,
) -> Tuple[List[str], List[int]]:
    """Encode the corpus as MJPG .avi files in UCF101 layout under ``root``.

    Returns (train_rel_paths, train_labels). Every ``test_every``-th video of
    a class goes to testlist01.txt instead (exercises split parsing the way
    the reference's fold files do). classInd.txt carries the factor label
    directly as the class index, 0-based (real UCF101 ships 1-based indices —
    parse_class_index takes the file's values either way; 0-based here keeps
    label%8 == color octant for the persisted eval assets).
    """
    import cv2

    rng = np.random.RandomState(seed)
    vid_dir = os.path.join(root, "videos")
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(ann_dir, exist_ok=True)

    with open(os.path.join(ann_dir, "classInd.txt"), "w") as f:
        for label in range(64):
            f.write(f"{label} {class_name(label)}\n")

    per_class_count = {}
    train_paths, train_labels, test_paths = [], [], []
    fourcc = cv2.VideoWriter_fourcc(*"MJPG")
    it = range(n_videos)
    if progress:
        try:
            from tqdm import tqdm
            it = tqdm(it, desc="encoding corpus")
        except ImportError:
            pass
    for _ in it:
        n_frames = rng.randint(min_frames, max_frames + 1)
        video, label = moving_square_video(rng, n_frames)
        cls = class_name(label)
        k = per_class_count.get(label, 0)
        per_class_count[label] = k + 1
        rel = f"{cls}/v_{cls}_g01_c{k + 1:03d}.avi"
        path = os.path.join(vid_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        w = cv2.VideoWriter(path, fourcc, fps, (WIDTH, HEIGHT))
        if not w.isOpened():
            raise RuntimeError(f"cv2.VideoWriter failed to open {path}")
        for t in range(n_frames):
            w.write(video[t, :, :, ::-1])  # RGB -> BGR
        w.release()
        if test_every and (k + 1) % test_every == 0:
            test_paths.append(rel)
        else:
            train_paths.append(rel)
            train_labels.append(label)

    with open(os.path.join(ann_dir, "trainlist01.txt"), "w") as f:
        for rel, label in zip(train_paths, train_labels):
            f.write(f"{rel} {label}\n")
    with open(os.path.join(ann_dir, "testlist01.txt"), "w") as f:
        for rel in test_paths:
            f.write(f"{rel}\n")
    return train_paths, train_labels
