"""Host-side video decoding with OpenCV (FFmpeg), once, offline (twin of
``ganode_tpu/data/video.py``).

The reference read videos with torchvision's PyAV reader (reference
dataset/video/video_utils.py): it decoded every video end to end to learn
its length (reference dataset/ucf101new.py:59-67) and decoded a random
window again in every ``__getitem__``. Here decoding happens once, when
``data/ucf101.py::pack_ucf101`` packs a split into uint8 frames that the
samplers and the native loader read from memory.

``cv2`` is imported when a function needs it, not with the module: a
machine that only trains from a pack needs no OpenCV. The AVI audio demuxer
is the standard library's alone.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _require_cv2():
    """The ``cv2`` module; raises when OpenCV is absent."""
    try:
        import cv2  # OpenCV ships an FFmpeg-backed VideoCapture
    except ImportError as e:
        raise RuntimeError(
            "video decode requires OpenCV (cv2); install opencv-python or "
            "pack the dataset on a machine that has it") from e
    return cv2


def probe_length(path: str) -> int:
    """Frame count without decoding (container metadata) — replaces the
    reference's full-decode length probe."""
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(path)
    try:
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()
    return max(n, 0)


def read_video(path: str, start: int = 0, end: Optional[int] = None) -> np.ndarray:
    """Decode frames [start, end] inclusive -> (T, H, W, C) uint8 RGB.

    Mirrors the reference's read_video frame-index semantics
    (dataset/ucf101new.py:88-90 passes inclusive end frames).
    """
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        if start > 0:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        idx = start
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            idx += 1
            if end is not None and idx > end:
                break
    finally:
        cap.release()
    if not frames:
        return np.zeros((0, 0, 0, 3), np.uint8)
    return np.stack(frames)


def default_resize_geometry(image_size: int) -> Tuple[Tuple[int, int], int]:
    """Scale the reference's 64 -> resize(64, 85) + x-crop[10:74] recipe
    (reference dataset/ucf101new.py:31,73-78) proportionally to any output size:
    128 -> resize(128, 170) + x-crop[20:148]. Returns ((h, w), x_offset)."""
    w = int(round(image_size * 85 / 64))
    x_offset = int(round(image_size * 10 / 64))
    if x_offset + image_size > w:  # guard tiny sizes against rounding
        x_offset = w - image_size
    return (image_size, w), x_offset


def resize_crop(video: np.ndarray, image_size: int = 64,
                resize_hw: Optional[Tuple[int, int]] = None,
                x_offset: Optional[int] = None) -> np.ndarray:
    """Bicubic resize then x-crop -> (T, image_size, image_size, C).

    Geometry defaults to the reference's spatial pipeline scaled to
    ``image_size`` (see default_resize_geometry); at 64 this is exactly the
    reference's resize(64, 85) + crop x[10:74] (dataset/ucf101new.py:31,73-78).
    """
    cv2 = _require_cv2()
    default_hw, default_x = default_resize_geometry(image_size)
    h, w = resize_hw if resize_hw is not None else default_hw
    if x_offset is None:
        x_offset = default_x
    if x_offset + image_size > w or h < image_size:
        raise ValueError(
            f"resize geometry (h={h}, w={w}, x_offset={x_offset}) cannot "
            f"produce a {image_size}x{image_size} crop")
    out = np.empty((video.shape[0], h, w, video.shape[-1]), video.dtype)
    for t in range(video.shape[0]):
        out[t] = cv2.resize(video[t], (w, h), interpolation=cv2.INTER_CUBIC)
    return out[:, :, x_offset:x_offset + image_size, :]


def read_video_timestamps(path: str) -> Tuple[np.ndarray, float]:
    """Per-frame presentation timestamps in SECONDS + container fps.

    The pts surface of the reference's vendored reader (reference
    dataset/video/video_utils.py:201-210 pts_convert, :296-315 parallel
    timestamp scan): its VideoClips needed real pts to window variable-
    frame-rate videos. Here timestamps come from FFmpeg via OpenCV's
    CAP_PROP_POS_MSEC after each ``grab()`` (container demux only, no pixel
    decode), so VFR files report their true, non-uniform pts rather than a
    frame_index/fps approximation.
    """
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(path)
    pts = []
    try:
        fps = float(cap.get(cv2.CAP_PROP_FPS))
        while cap.grab():
            pts.append(cap.get(cv2.CAP_PROP_POS_MSEC) / 1000.0)
    finally:
        cap.release()
    fps = fps if np.isfinite(fps) and fps > 0 else 0.0
    out = np.asarray(pts, np.float64)
    # some containers report POS_MSEC of the NEXT frame or 0 for the first;
    # normalize so pts[0] == 0 like the reference's start-offset handling
    if out.size and out[0] > 0:
        out = out - out[0]
    return out, fps


# ---------------------------------------------------------------- AVI audio
# OpenCV's VideoCapture is video-only, and the package relies on no other
# decoder (PyAV, an ffmpeg binary, torchaudio). But AVI is a plain
# RIFF container, so UNCOMPRESSED audio tracks (PCM / IEEE-float — the
# formats a demuxer alone can "decode") are readable with the stdlib. This
# closes the reference reader's audio surface (reference
# dataset/video/video_utils.py:117-198 returns (vframes, aframes, info)) for
# the decodable subset; compressed codecs (MP3 etc.) stay a documented empty.

_PCM_DTYPES = {  # (wFormatTag, wBitsPerSample) -> numpy dtype
    (1, 8): np.uint8, (1, 16): np.int16, (1, 32): np.int32,
    (3, 32): np.float32, (3, 64): np.float64,
}


def _riff_chunks(buf, pos: int, end: int):
    """Yield (fourcc, data_start, data_size) over a RIFF chunk run; chunk
    payloads are padded to even offsets per the RIFF spec."""
    import struct

    while pos + 8 <= end:
        fourcc = bytes(buf[pos:pos + 4])
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        data = pos + 8
        if data + size > end:  # corrupt tail: stop at what fits
            size = max(end - data, 0)
        yield fourcc, data, size
        pos = data + size + (size & 1)


def read_avi_pcm_audio(path: str):
    """Demux an AVI's first uncompressed audio stream with the stdlib.

    Returns (samples, rate): samples (K, L) float32 in [-1, 1] — channels x
    samples, the reference reader's aframes layout (reference
    dataset/video/video_utils.py:137-139 "Tensor[K, L]") — and the sample
    rate. Returns None when the file is not an AVI, has no audio stream, or
    the stream's codec is compressed (a demuxer cannot decode MP3/AAC).
    """
    import mmap
    import struct

    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            return None
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            file_end = len(buf)
            fmt = None          # (tag, channels, rate, bits)
            audio_ix = None     # stream ordinal -> '##wb' chunk id
            movi = None
            stream_ix = 0
            for cc, data, size in _riff_chunks(buf, 12, file_end):
                if cc != b"LIST":
                    continue
                ltype = bytes(buf[data:data + 4])
                if ltype == b"hdrl":
                    for cc2, d2, s2 in _riff_chunks(buf, data + 4, data + size):
                        if cc2 != b"LIST" or bytes(buf[d2:d2 + 4]) != b"strl":
                            continue
                        is_auds, strf = False, None
                        for cc3, d3, s3 in _riff_chunks(buf, d2 + 4, d2 + s2):
                            if cc3 == b"strh":
                                is_auds = bytes(buf[d3:d3 + 4]) == b"auds"
                            elif cc3 == b"strf":
                                strf = (d3, s3)
                        if is_auds and fmt is None and strf and strf[1] >= 16:
                            tag, ch, rate, _, _, bits = struct.unpack_from(
                                "<HHIIHH", buf, strf[0])
                            fmt = (tag, ch, rate, bits)
                            audio_ix = stream_ix
                        stream_ix += 1
                elif ltype == b"movi":
                    movi = (data + 4, data + size)
            if fmt is None or movi is None:
                return None
            tag, channels, rate, bits = fmt
            dtype = _PCM_DTYPES.get((tag, bits))
            if dtype is None or channels < 1 or rate <= 0:
                return None  # compressed / exotic: demux alone can't decode

            want = b"%02dwb" % audio_ix
            parts = []

            def collect(lo, hi):
                for cc, d, s in _riff_chunks(buf, lo, hi):
                    if cc == want:
                        parts.append(bytes(buf[d:d + s]))
                    elif cc == b"LIST" and bytes(buf[d:d + 4]) == b"rec ":
                        collect(d + 4, d + s)  # grouped records

            collect(*movi)
            if not parts:
                return None
            raw = np.frombuffer(b"".join(parts), dtype=dtype)
            raw = raw[: (raw.size // channels) * channels]
            samples = raw.reshape(-1, channels).T.astype(np.float32)
            if tag == 1:  # integer PCM -> [-1, 1]
                if bits == 8:
                    samples = (samples - 128.0) / 128.0
                else:
                    samples = samples / float(2 ** (bits - 1))
            return samples, int(rate)
        finally:
            buf.close()


def read_video_with_info(path: str, start: int = 0,
                         end: Optional[int] = None):
    """(video, audio, info) with the reference reader's return contract
    (reference dataset/video/video_utils.py:117-198 read_video returns video
    frames, audio samples, and an info dict with video_fps/audio_fps).

    video: (T, H, W, C) uint8 RGB frames [start, end] inclusive.
    audio: (K, L) float32 channels-x-samples (the reference's aframes layout,
        video_utils.py:137-139), trimmed to the returned frames' time window
        like the reference's _align_audio_frames. Audio comes from the
        stdlib RIFF demuxer above, so only UNCOMPRESSED tracks (PCM /
        IEEE-float) decode; compressed codecs (OpenCV is video-only, and
        no other decoder is used) yield the documented empty (0, 0) array with
        ``info['audio_fps'] is None`` marking the stream as undecodable.
    info: {'video_fps': float, 'audio_fps': int | None,
           'pts': per-returned-frame presentation timestamps (seconds)}.
    """
    video = read_video(path, start, end)
    pts, fps = read_video_timestamps(path)
    stop = start + video.shape[0]
    frame_pts = pts[start:stop]
    if frame_pts.shape[0] != video.shape[0] or (
            frame_pts.size > 1 and np.all(frame_pts[1:] == 0.0)):
        # keep the documented one-pts-per-returned-frame contract even when
        # the demux pass (grab) and the decode pass (read) disagree on frame
        # count (corrupt tail), or when the container doesn't support
        # POS_MSEC (all-zero pts): degrade to frame-index/fps timestamps
        # instead of returning a misaligned or degenerate array
        step = 1.0 / fps if fps > 0 else 1.0
        frame_pts = (start + np.arange(video.shape[0], dtype=np.float64)) * step
    audio, audio_fps = np.zeros((0, 0), np.float32), None
    decoded = read_avi_pcm_audio(path)
    if decoded is not None:
        audio, audio_fps = decoded
        if frame_pts.size:  # trim to the returned frames' time window
            t0 = frame_pts[0]
            t1 = frame_pts[-1] + (1.0 / fps if fps > 0 else 0.0)
            audio = audio[:, int(round(t0 * audio_fps)):
                          int(round(t1 * audio_fps))]
    info = {
        "video_fps": fps,
        "audio_fps": audio_fps,
        "pts": frame_pts,
    }
    return video, audio, info


def probe_fps(path: str) -> float:
    """Container-reported frames-per-second (0.0 when unknown)."""
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(path)
    try:
        fps = float(cap.get(cv2.CAP_PROP_FPS))
    finally:
        cap.release()
    return fps if np.isfinite(fps) and fps > 0 else 0.0


def resample_frame_indices(n_frames: int, original_fps: float,
                           target_fps: Optional[float]) -> np.ndarray:
    """Frame indices that resample an n_frames clip to target_fps.

    Matches the semantics of the reference's VideoClips resampling
    (reference dataset/video/video_utils.py:350-388): the output has
    floor(n_frames * target/original) frames; an integer fps ratio becomes a
    pure stride, otherwise indices are floor(arange(m) * original/target).
    No resampling (target None/<=0 or unknown source fps) is the identity.
    """
    if not target_fps or target_fps <= 0 or not original_fps or original_fps <= 0:
        return np.arange(n_frames, dtype=np.int64)
    step = original_fps / target_fps
    m = int(np.floor(n_frames * target_fps / original_fps))
    m = max(m, 1) if n_frames > 0 else 0
    if float(step).is_integer():
        return np.arange(0, n_frames, int(step), dtype=np.int64)[:m]
    idx = np.floor(np.arange(m, dtype=np.float64) * step).astype(np.int64)
    return np.minimum(idx, max(n_frames - 1, 0))
