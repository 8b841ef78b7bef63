"""Qualitative sampling: the n x n animated GIF grid (twin of
``ganode_tpu/utils/gifs.py``).

The JAX package hands its frames to PIL. The port writes GIF89a itself, in
numpy and Python, so it needs no imaging library: a fixed global palette (256
grays for 1-channel frames, a 6 x 6 x 6 colour cube for RGB), a NETSCAPE
block that loops the animation, and each frame's LZW code stream. The stream
holds every pixel as a literal 9-bit code, with a clear code before each run
of ``_RUN`` pixels so that the decoder's table never outgrows 9 bits. That is
valid LZW which every decoder reads, and it packs in numpy at ~1.1 bytes per
pixel with no dictionary loop in Python.

Colour error: none for 1-channel frames; for RGB each channel is rounded to
the nearest multiple of 51, at most 25 levels off.

``read_gif`` decodes a GIF (any LZW stream, global or local palettes, frames
at an offset; not interlaced ones) back to RGB frames, so that a written
grid can be checked where no imaging library is installed.
"""
from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

_CLEAR, _END = 256, 257     # LZW control codes at minimum code size 8
_CODE_BITS = 9
# Literals per clear code. After a clear the decoder adds a table entry for
# every code but the first: 253 literals add 252 (258..509), so the next free
# entry stays below 512, where it would widen codes to 10 bits (with one to
# spare for a decoder that widens a code early).
_RUN = 253
_CUBE = 6                   # RGB palette levels per channel
_CUBE_STEP = 255 // (_CUBE - 1)


def video_grid(videos: np.ndarray, n: Optional[int] = None) -> np.ndarray:
    """(n*n, T, H, W, C) in [-1, 1] -> (T, n*H, n*W, C) uint8 grid."""
    videos = np.asarray(videos)
    count, t, h, w, c = videos.shape
    n = n or int(np.sqrt(count))
    if n * n > count:
        raise ValueError(f"an {n}x{n} grid needs {n * n} videos, got {count}")
    grid = np.zeros((t, n * h, n * w, c), videos.dtype)
    for j in range(n):
        for k in range(n):
            grid[:, h * j:h * (j + 1), w * k:w * (k + 1), :] = videos[j * n + k]
    grid = (grid + 1.0) / 2.0 * 255.0
    return np.clip(grid, 0, 255).astype(np.uint8)


def _palette_and_indices(frames: np.ndarray):
    """(T, H, W, C) uint8 -> (768-byte global palette, (T, H, W) uint8
    palette indices)."""
    if frames.shape[-1] == 1:
        levels = np.arange(256, dtype=np.uint8)
        palette = np.repeat(levels[:, None], 3, axis=1)
        return palette.tobytes(), frames[..., 0]
    if frames.shape[-1] != 3:
        raise ValueError(f"frames need 1 or 3 channels, got {frames.shape[-1]}")
    q = (frames.astype(np.int32) + _CUBE_STEP // 2) // _CUBE_STEP  # 0.._CUBE-1
    idx = (q[..., 0] * _CUBE + q[..., 1]) * _CUBE + q[..., 2]
    r, g, b = np.meshgrid(*[np.arange(_CUBE)] * 3, indexing="ij")
    palette = np.zeros((256, 3), np.uint8)
    palette[:_CUBE ** 3] = np.stack([r, g, b], -1).reshape(-1, 3) * _CUBE_STEP
    return palette.tobytes(), idx.astype(np.uint8)


def _lzw_literal(indices: np.ndarray) -> bytes:
    """One frame's palette indices -> its LZW code stream (9-bit codes
    packed LSB first): a clear code before each run of ``_RUN`` literals,
    the end code last."""
    flat = indices.ravel().astype(np.uint16)
    n = flat.size
    runs = -(-n // _RUN)
    padded = np.zeros(runs * _RUN, np.uint16)
    padded[:n] = flat
    codes = np.concatenate(
        [np.column_stack([np.full(runs, _CLEAR, np.uint16),
                          padded.reshape(runs, _RUN)]).ravel()[:n + runs],
         np.array([_END], np.uint16)])
    bits = ((codes[:, None] >> np.arange(_CODE_BITS, dtype=np.uint16)) & 1)
    return np.packbits(bits.astype(np.uint8).ravel(), bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    """GIF data sub-blocks (a length byte, up to 255 bytes), then the empty
    block that ends them."""
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def write_gif(path: str, frames: np.ndarray, *, fps: int = 8):
    """frames: (T, H, W, C) uint8 (C in {1, 3}) -> an animated GIF89a at
    ``path`` that loops forever, ``int(1000 / fps)`` ms per frame rounded down
    to the format's 10 ms units."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4:
        raise ValueError(f"frames must be (T, H, W, C) uint8, got "
                         f"{frames.dtype} {frames.shape}")
    t, h, w, _ = frames.shape
    palette, indices = _palette_and_indices(frames)
    delay = int(1000 / fps) // 10
    out = [b"GIF89a",
           # logical screen: global palette of 2 ** (7 + 1) entries
           struct.pack("<HHBBB", w, h, 0xF7, 0, 0), palette,
           b"\x21\xFF\x0BNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for i in range(t):
        out.append(b"\x21\xF9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08")
        out.append(_sub_blocks(_lzw_literal(indices[i])))
    out.append(b"\x3B")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return path


def save_sample_grid(path: str, videos, n: Optional[int] = None, fps: int = 8):
    """One call matching the reference genSamples layout: 8x8 grid GIF."""
    return write_gif(path, video_grid(np.asarray(videos), n), fps=fps)


def _lzw_decode(data: bytes, min_size: int, count: int) -> np.ndarray:
    """A GIF LZW code stream (codes LSB first, widening from ``min_size +
    1`` bits up to 12) -> its first ``count`` palette indices."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    size, pos, prev = min_size + 1, 0, None
    out = bytearray()
    padded = data + b"\0\0\0"
    while pos + size <= 8 * len(data):
        word = int.from_bytes(padded[pos >> 3:(pos >> 3) + 3], "little")
        code = (word >> (pos & 7)) & ((1 << size) - 1)
        pos += size
        if code == clear:
            del table[clear + 2:]
            size, prev = min_size + 1, None
            continue
        if code == end:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None:
                table.append(prev + entry[:1])
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"bad LZW code {code}")
        out += entry
        prev = entry
        if len(table) == 1 << size and size < 12:
            size += 1
    if len(out) < count:
        raise ValueError(f"LZW stream holds {len(out)} pixels, not {count}")
    return np.frombuffer(bytes(out[:count]), np.uint8)


def read_gif(path: str) -> np.ndarray:
    """A GIF at ``path`` -> its frames ``(T, H, W, 3)`` uint8 RGB, each drawn
    over the one before (a graphic control block's transparent index keeps
    the pixel below)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos, palette = 13, None

    def table(flags, pos):
        n = 2 << (flags & 7)
        return (np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(n, 3),
                pos + 3 * n)

    def sub_blocks(pos):
        chunks = []
        while data[pos]:
            chunks.append(data[pos + 1:pos + 1 + data[pos]])
            pos += 1 + data[pos]
        return b"".join(chunks), pos + 1

    if flags & 0x80:
        palette, pos = table(flags, pos)
    frames, canvas = [], np.zeros((h, w, 3), np.uint8)
    transparent = None
    while data[pos] != 0x3B:
        if data[pos] == 0x21:                      # an extension
            body, end = sub_blocks(pos + 2)
            if data[pos + 1] == 0xF9:              # graphic control
                transparent = body[3] if body[0] & 1 else None
            pos = end
        elif data[pos] == 0x2C:                    # an image
            x, y, fw, fh, fl = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
            pos += 10
            pal = palette
            if fl & 0x80:
                pal, pos = table(fl, pos)
            if fl & 0x40:
                raise ValueError(f"{path}: interlaced frames are not read")
            min_size = data[pos]
            stream, pos = sub_blocks(pos + 1)
            idx = _lzw_decode(stream, min_size, fw * fh)
            idx = idx.reshape(fh, fw)
            canvas = canvas.copy()
            region = canvas[y:y + fh, x:x + fw]
            drawn = (np.ones(idx.shape, bool) if transparent is None
                     else idx != transparent)
            region[drawn] = pal[idx[drawn]]
            frames.append(canvas)
            transparent = None
        else:
            raise ValueError(f"{path}: unknown block {data[pos]:#x}")
    return np.stack(frames)
