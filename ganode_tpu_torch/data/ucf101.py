"""Packed UCF101: the pack format, its memory-mapped reader and the clip and
frame samplers (twin of ``ganode_tpu/data/ucf101.py:133-258``; decoding and
``pack_ucf101`` wait for ROADMAP M15).

A pack directory holds ``frames.u8`` (every frame of every video, uint8
``(H, W, C)``, one after another), ``index.npz`` (each video's ``offsets``,
``lengths`` and ``labels``) and ``meta.json``. The format is the JAX
package's: a pack written by either package reads the same in the other.

Each sampler's ``draw(rng)`` takes the random video picks and uniforms from
a ``numpy.random.Generator``, and ``gather(pick, u)`` is a deterministic
function of them (``data/sampling.py``).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from .sampling import Sampler

_FRAMES_FILE = "frames.u8"
_INDEX_FILE = "index.npz"
_META_FILE = "meta.json"


def pack_arrays(out_dir: str, videos: List[np.ndarray], labels: List[int],
                *, image_size: int = 64, n_frame: int = 16,
                source_fps: Optional[List[float]] = None) -> str:
    """Pack pre-decoded (T, H, W, C) uint8 arrays into ``out_dir``.

    ``source_fps`` optionally records per-video frame rates in meta.json.
    """
    os.makedirs(out_dir, exist_ok=True)
    offsets, lengths = [], []
    offset = 0
    with open(os.path.join(out_dir, _FRAMES_FILE), "wb") as out:
        for v in videos:
            v = np.ascontiguousarray(v.astype(np.uint8))
            out.write(v.tobytes())
            offsets.append(offset)
            lengths.append(v.shape[0])
            offset += v.shape[0]
    np.savez(os.path.join(out_dir, _INDEX_FILE),
             offsets=np.asarray(offsets, np.int64),
             lengths=np.asarray(lengths, np.int64),
             labels=np.asarray(labels, np.int64))
    with open(os.path.join(out_dir, _META_FILE), "w") as f:
        json.dump({"image_size": image_size, "n_frame": n_frame, "channels": 3,
                   "classes": [], "paths": [], "total_frames": offset,
                   "source_fps": source_fps}, f)
    return out_dir


class PackedVideoDataset:
    """Read-only memory map over a pack directory."""

    def __init__(self, pack_dir: str):
        with open(os.path.join(pack_dir, _META_FILE)) as f:
            self.meta = json.load(f)
        idx = np.load(os.path.join(pack_dir, _INDEX_FILE))
        self.offsets = idx["offsets"]
        self.lengths = idx["lengths"]
        self.labels = idx["labels"]
        s = self.meta["image_size"]
        c = self.meta["channels"]
        self.frames = np.memmap(
            os.path.join(pack_dir, _FRAMES_FILE), dtype=np.uint8, mode="r",
            shape=(self.meta["total_frames"], s, s, c),
        )

    def __len__(self):
        return len(self.offsets)

    def clip(self, video_idx: int, start: int, n_frame: int) -> np.ndarray:
        o = self.offsets[video_idx]
        return np.asarray(self.frames[o + start: o + start + n_frame])

    def frame(self, video_idx: int, t: int) -> np.ndarray:
        return np.asarray(self.frames[self.offsets[video_idx] + t])


def _normalize(x: np.ndarray) -> np.ndarray:
    """(v - 128) / 128 -> float32 in [-1, 1] (reference dataset/ucf101new.py:95)."""
    return (x.astype(np.float32) - 128.0) / 128.0


class _PackSampler(Sampler):
    def draw(self, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """(a pick among the eligible videos, a uniform in [0, 1)) per clip."""
        return (rng.integers(0, len(self.eligible), self.batch_size),
                rng.random(self.batch_size))


class UCF101ClipSampler(_PackSampler):
    """Random n_frame windows -> (B, T, H, W, C) in [-1, 1].

    ``host_id``/``host_count`` stride the video index, so that each of
    several hosts samples only its stripe of the dataset.
    """

    def __init__(self, pack_dir: str, batch_size: int, *, n_frame: int = 16,
                 host_id: int = 0, host_count: int = 1):
        self.ds = PackedVideoDataset(pack_dir)
        self.batch_size = batch_size
        self.n_frame = n_frame
        eligible = np.nonzero(self.ds.lengths >= n_frame)[0]
        self.eligible = eligible[host_id::host_count]
        if len(self.eligible) == 0:
            raise ValueError("no videos long enough for the requested clip length")

    def gather(self, pick, u) -> Tuple[np.ndarray, np.ndarray]:
        """The clip of eligible video ``pick`` starting at ``u`` of its
        possible starts, for each pair."""
        vids = self.eligible[np.asarray(pick)]
        max_start = self.ds.lengths[vids] - self.n_frame
        starts = (np.asarray(u) * (max_start + 1)).astype(np.int64)
        clips = np.stack([
            self.ds.clip(int(v), int(s), self.n_frame)
            for v, s in zip(vids, starts)
        ])
        return _normalize(clips), self.ds.labels[vids]


class UCF101ImageSampler(_PackSampler):
    """Single random frames -> (B, H, W, C) in [-1, 1]
    (reference dataset/ucf101new.py:169-180)."""

    def __init__(self, pack_dir: str, batch_size: int, *, host_id: int = 0,
                 host_count: int = 1):
        self.ds = PackedVideoDataset(pack_dir)
        self.batch_size = batch_size
        self.eligible = np.arange(len(self.ds))[host_id::host_count]

    def gather(self, pick, u) -> Tuple[np.ndarray, np.ndarray]:
        """Frame ``u`` of the way through eligible video ``pick``."""
        vids = self.eligible[np.asarray(pick)]
        ts = (np.asarray(u) * self.ds.lengths[vids]).astype(np.int64)
        frames = np.stack([self.ds.frame(int(v), int(t))
                           for v, t in zip(vids, ts)])
        return _normalize(frames), self.ds.labels[vids]
