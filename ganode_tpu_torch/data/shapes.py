"""Synthetic moving-square videos: the JAX package's learnable stand-in for
UCF101 clips (``scripts/demo_tpu_train.py:28-59``), the reals its north-star
run is scored against.

numpy only, with the same ``RandomState(seed)`` draws in the same order, so
the output equals the JAX script's bit for bit.
"""
from __future__ import annotations

import numpy as np


def synthetic_moving_shapes(n_videos: int, T: int, size: int = 64,
                            seed: int = 0):
    """Color videos of a bright square translating along a random line ->
    (videos (n, T, size, size, 3) float32 in [-1, 1], labels (n,) int64).

    label = direction_octant * 8 + color_octant: the motion vector (dx, dy)
    binned into 8 compass directions (visible in a video) and each RGB
    channel thresholded at 0.6 (visible in a frame; the IS classifier trains
    on labels % 8).
    """
    rng = np.random.RandomState(seed)
    side = 12 if size <= 64 else 24
    videos = np.full((n_videos, T, size, size, 3), -1.0, np.float32)
    labels = np.zeros(n_videos, np.int64)
    for i in range(n_videos):
        color = rng.uniform(0.2, 1.0, 3)
        x0, y0 = rng.randint(4, size - side - 4, 2)
        dx, dy = 0, 0
        while dx == 0 and dy == 0:
            dx, dy = rng.randint(-2, 3, 2)
        for t in range(T):
            x = int(np.clip(x0 + dx * t, 0, size - side))
            y = int(np.clip(y0 + dy * t, 0, size - side))
            videos[i, t, y:y + side, x:x + side, :] = color
        octant = int(np.round(np.arctan2(dy, dx) / (np.pi / 4))) % 8
        color_bucket = int((color > 0.6) @ np.array([4, 2, 1]))
        labels[i] = octant * 8 + color_bucket
    return videos, labels
