"""VideoClips-equivalent clip index: enumerable, fps-accurate clip windows
(twin of ``ganode_tpu/data/clips.py``).

The reference's vendored torchvision ``VideoClips`` (reference
dataset/video/video_utils.py:247-513) precomputes, for a list of videos,
every sliding window of ``num_frames`` frames taken ``step`` apart,
optionally after resampling each video to a target ``frame_rate``, and
serves clip ``idx`` by mapping it to (video_idx, clip_idx) and decoding that
window. Here the decode already happened at pack time (``data/ucf101.py``),
so the same API is index algebra over the packed store, with clip timestamps
from the per-video source fps in ``meta.json``:

  * ``unfold``: sliding windows with dilation 1 (video_utils.py:213-229);
  * per-video resampling to ``frame_rate`` by floor-index resampling
    (video_utils.py:350-388, ``data/video.py::resample_frame_indices``);
  * ``get_clip_location`` / ``get_clip``: global clip idx -> (video_idx,
    clip_idx) by cumulative counts (video_utils.py:398-513), returning the
    frames, the info dict (fps after resampling) and the video index;
  * videos shorter than one window contribute zero clips.

``UCF101RandomClipSampler`` follows the package's draw/gather split
(``data/sampling.py``): ``draw(rng)`` picks from a
``numpy.random.Generator``, ``gather(pick)`` is deterministic.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from .sampling import Sampler
from .ucf101 import PackedVideoDataset, _normalize
from .video import resample_frame_indices


def unfold(indices: np.ndarray, size: int, step: int) -> np.ndarray:
    """All full sliding windows ``indices[i : i + size]`` for i = 0, step,
    ..., as ``torch.Tensor.unfold(0, size, step)``: windows that would run
    past the end are dropped; fewer than ``size`` frames give (0, size)."""
    n = len(indices)
    if n < size:
        return np.empty((0, size), dtype=np.int64)
    starts = np.arange(0, n - size + 1, step, dtype=np.int64)
    return indices[starts[:, None] + np.arange(size, dtype=np.int64)[None, :]]


def compute_clips_for_video(n_frames: int, num_frames: int, step: int,
                            original_fps: float,
                            frame_rate: Optional[float]) -> np.ndarray:
    """(n_clips, num_frames) source-frame indices for one video: its frame
    list resampled to ``frame_rate`` (identity when None or unknown), then
    unfolded into windows."""
    idxs = resample_frame_indices(n_frames, original_fps, frame_rate)
    return unfold(idxs, num_frames, step)


class ClipIndex:
    """Precomputed clip windows over a ``PackedVideoDataset``; the
    parameters mirror VideoClips(video_paths, clip_length_in_frames,
    frames_between_clips, frame_rate) (video_utils.py:272-286)."""

    def __init__(self, ds: PackedVideoDataset, num_frames: int = 16,
                 step: int = 1, frame_rate: Optional[float] = None):
        self.ds = ds
        self.num_frames = num_frames
        self.step = step
        self.frame_rate = frame_rate
        src_fps = ds.meta.get("source_fps") or [0.0] * len(ds)
        # a pack built at target_fps already plays at that rate; clip-level
        # resampling then starts from the packed rate, not the original
        packed_fps = [ds.meta.get("target_fps") or f for f in src_fps]
        self.clips = [
            compute_clips_for_video(int(n), num_frames, step, fps, frame_rate)
            for n, fps in zip(ds.lengths, packed_fps)
        ]
        self.packed_fps = packed_fps
        counts = np.asarray([len(c) for c in self.clips], np.int64)
        self.cumulative = np.concatenate([[0], np.cumsum(counts)])

    def num_clips(self) -> int:
        return int(self.cumulative[-1])

    def get_clip_location(self, idx: int) -> Tuple[int, int]:
        """Global clip idx -> (video_idx, clip_idx within that video)."""
        if not 0 <= idx < self.num_clips():
            raise IndexError(
                f"clip index {idx} out of range ({self.num_clips()} clips)")
        video_idx = int(np.searchsorted(self.cumulative, idx, "right") - 1)
        return video_idx, int(idx - self.cumulative[video_idx])

    def get_clip(self, idx: int) -> Tuple[np.ndarray, dict, int]:
        """-> (frames (num_frames, H, W, C) uint8, info, video_idx); info
        carries the effective fps, as the reference's get_clip returned
        {'video_fps': ...} after resampling (video_utils.py:505-510)."""
        video_idx, clip_idx = self.get_clip_location(idx)
        window = self.clips[video_idx][clip_idx]
        o = int(self.ds.offsets[video_idx])
        frames = np.asarray(self.ds.frames[o + window])
        fps = self.frame_rate or self.packed_fps[video_idx]
        return frames, {"video_fps": fps}, video_idx

    def gather(self, ids) -> Tuple[np.ndarray, np.ndarray]:
        """Clips ``ids`` -> (normalized [-1, 1] float32 (n, T, H, W, C),
        their labels)."""
        frames, vids = [], []
        for i in ids:
            f, _, v = self.get_clip(int(i))
            frames.append(f)
            vids.append(v)
        return _normalize(np.stack(frames)), self.ds.labels[vids]


class UCF101SequentialClips:
    """Deterministic enumeration of every clip, the eval-side serving path
    (the reference iterated a DataLoader over the VideoClips-backed
    dataset). Yields normalized [-1, 1] float batches; the last short batch
    is kept."""

    def __init__(self, pack_dir: str, batch_size: int, *, num_frames: int = 16,
                 step: int = 1, frame_rate: Optional[float] = None):
        self.index = ClipIndex(PackedVideoDataset(pack_dir), num_frames,
                               step, frame_rate)
        self.batch_size = batch_size

    def __len__(self):
        return self.index.num_clips()

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = self.index.num_clips()
        for lo in range(0, n, self.batch_size):
            yield self.index.gather(range(lo, min(lo + self.batch_size, n)))


class UCF101RandomClipSampler(Sampler):
    """Uniform sampler over the precomputed clip set (against
    ``UCF101ClipSampler``'s random-window draw): every clip window is
    equally likely, as in a shuffled DataLoader over the VideoClips
    dataset. ``host_id``/``host_count`` stride the clip index."""

    def __init__(self, pack_dir: str, batch_size: int, *, num_frames: int = 16,
                 step: int = 1, frame_rate: Optional[float] = None,
                 host_id: int = 0, host_count: int = 1):
        self.index = ClipIndex(PackedVideoDataset(pack_dir), num_frames,
                               step, frame_rate)
        self.batch_size = batch_size
        self.eligible = np.arange(self.index.num_clips())[host_id::host_count]
        if len(self.eligible) == 0:
            raise ValueError("no clips available for this host stripe")

    def draw(self, rng: np.random.Generator) -> Tuple[np.ndarray]:
        return (rng.integers(0, len(self.eligible), self.batch_size),)

    def gather(self, pick) -> Tuple[np.ndarray, np.ndarray]:
        """The eligible clips ``pick``."""
        return self.index.gather(self.eligible[np.asarray(pick)])
