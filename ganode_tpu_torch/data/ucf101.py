"""Packed UCF101: the offline pack, its format, its memory-mapped reader and
the clip and frame samplers (twin of ``ganode_tpu/data/ucf101.py``).

``pack_ucf101`` decodes a split once (``data/video.py``, OpenCV), resizes
bicubic to (64, 85) and crops x[10:74] (the reference's spatial pipeline,
scaled for other sizes), and writes the pack; the samplers and the native
loader (``runtime/``) then serve windows by indexing, with no decoder in
the training loop. The annotations are read as the reference reads them:
``classInd.txt`` for the classes (reference dataset/ucf101new.py:35-46) and
``{train,test}list0{fold}.txt`` for the split (:49-68); videos shorter than
``n_frame`` are left out at pack time.

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
from typing import Dict, List, Optional, Tuple

import numpy as np

from .sampling import Sampler

_FRAMES_FILE = "frames.u8"
_INDEX_FILE = "index.npz"
_META_FILE = "meta.json"


def parse_class_index(annotation_folder: str
                      ) -> Tuple[List[str], Dict[str, int]]:
    """``classInd.txt`` -> (class names in file order, name -> the file's
    index)."""
    classes, class_to_idx = [], {}
    with open(os.path.join(annotation_folder, "classInd.txt")) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            idx, name = int(parts[0]), parts[1].strip()
            classes.append(name)
            class_to_idx[name] = idx
    return classes, class_to_idx


def parse_split(annotation_folder: str, train: bool, fold: int) -> List[str]:
    """The relative paths of ``{train,test}list0{fold}.txt``."""
    if fold not in (1, 2, 3):
        raise ValueError(f"fold must be 1, 2 or 3, not {fold}")
    name = f"{'train' if train else 'test'}list0{fold}.txt"
    with open(os.path.join(annotation_folder, name)) as f:
        return [line.split()[0] for line in f if line.strip()]


def pack_ucf101(
    root: str,
    out_dir: str,
    *,
    video_folder: str = "videos",
    annotation_folder: str = "annotations",
    train: bool = True,
    fold: int = 1,
    n_frame: int = 16,
    image_size: int = 64,
    target_fps: Optional[float] = None,
    max_videos: Optional[int] = None,
    progress: bool = True,
) -> str:
    """Decode and preprocess a whole split of ``root`` into the pack
    ``out_dir`` -> ``out_dir``.

    Videos of a class missing from ``classInd.txt``, files that are absent
    and videos with fewer than ``n_frame`` decodable frames are left out.
    ``target_fps`` resamples each video to that rate first
    (``video.resample_frame_indices``); each kept video's source fps is
    recorded in ``meta.json``.
    """
    from .video import probe_fps, read_video, resample_frame_indices, resize_crop

    os.makedirs(out_dir, exist_ok=True)
    ann = os.path.join(root, annotation_folder)
    vid_root = os.path.join(root, video_folder)
    classes, class_to_idx = parse_class_index(ann)
    rel_paths = parse_split(ann, train, fold)
    if max_videos:
        rel_paths = rel_paths[:max_videos]

    offsets, lengths, labels, kept_paths, source_fps = [], [], [], [], []
    offset = 0
    with open(os.path.join(out_dir, _FRAMES_FILE), "wb") as out:
        it = rel_paths
        if progress:
            try:
                from tqdm import tqdm
                it = tqdm(rel_paths, desc="packing UCF101")
            except ImportError:
                pass
        for rel in it:
            cls = rel.split("/")[0]
            if cls not in class_to_idx:
                continue
            path = os.path.join(vid_root, rel)
            if not os.path.exists(path):
                continue
            video = read_video(path)
            fps = probe_fps(path)
            if target_fps:
                video = video[resample_frame_indices(video.shape[0], fps,
                                                     target_fps)]
            if video.shape[0] < n_frame:
                continue
            video = resize_crop(video, image_size)
            out.write(np.ascontiguousarray(video).tobytes())
            offsets.append(offset)
            lengths.append(video.shape[0])
            labels.append(class_to_idx[cls])
            kept_paths.append(rel)
            source_fps.append(fps)
            offset += video.shape[0]

    np.savez(os.path.join(out_dir, _INDEX_FILE),
             offsets=np.asarray(offsets, np.int64),
             lengths=np.asarray(lengths, np.int64),
             labels=np.asarray(labels, np.int64))
    with open(os.path.join(out_dir, _META_FILE), "w") as f:
        json.dump({
            "image_size": image_size, "n_frame": n_frame, "channels": 3,
            "classes": classes, "paths": kept_paths,
            "total_frames": offset,
            "target_fps": target_fps, "source_fps": source_fps,
        }, f)
    return out_dir


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
