"""The native clip loader: ``clip_loader.cc`` built with ``g++`` and bound
with ``ctypes`` (twin of ``ganode_tpu/runtime/native.py``).

``NativeClipLoader`` serves random ``n_frame`` windows of a pack directory
(``data/ucf101.py``), gathered and normalised by C++ worker threads ahead of
the caller. Batch i depends on ``(seed, i)`` alone, whatever the thread count,
and equals the JAX package's batch i for the same pack, seed and
``start_batch``. ``NativeClipSampler`` and ``NativeImageSampler`` give it the
port's sampler protocol, ``sample(rng)``, for ``train/runner.py``'s
``data_loader="native"``.

The library is compiled at first use into
``ganode_tpu_torch/_build/libclip_loader_<hash>.so`` (the hash covers the
source and the flags), written under a temporary name and moved into place
with ``os.replace``, so concurrent builders never load a half-written file.
Nothing here runs at import time. A missing ``g++`` or a failed build raises
with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "runtime" / "clip_loader.cc"
BUILD_DIR = _PKG / "_build"
# the JAX package's flags (ganode_tpu/runtime/native.py:build_library)
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread")

_libs: dict = {}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0"
                       + SOURCE.read_bytes())
    return BUILD_DIR / f"libclip_loader_{h.hexdigest()[:16]}.so"


def build_library(force: bool = False) -> str:
    """Compile ``clip_loader.cc`` unless this source and these flags are
    already built -> the library's path."""
    out = library_path()
    if out.exists() and not force:
        return str(out)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: it builds the native clip "
                           f"loader from {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return str(out)


def _load():
    path = build_library()
    lib = _libs.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
        lib.gl_open.restype = ctypes.c_void_p
        lib.gl_open.argtypes = [ctypes.c_char_p, p64, p64, p64, i64, i64, i64,
                                i64, i64, i64, i64, ctypes.c_uint64, i64]
        lib.gl_next.restype = ctypes.c_int
        lib.gl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float), p64]
        lib.gl_close.restype = None
        lib.gl_close.argtypes = [ctypes.c_void_p]
        _libs[path] = lib
    return lib


class NativeClipLoader:
    """C++ worker threads serving ``(clips (B, n_frame, H, W, C) float32 in
    [-1, 1], labels (B,) int64)`` from a pack directory.

    ``start_batch`` starts the stream at that batch: a loader opened at
    ``start_batch=n`` serves what an uninterrupted one serves from its batch
    n on (the runner's resume). Videos shorter than ``n_frame`` are never
    picked; with none long enough the loader refuses to open.
    """

    def __init__(self, pack_dir: str, batch_size: int, *, n_frame: int = 16,
                 n_threads: int = 4, seed: int = 0, start_batch: int = 0):
        from ..data.ucf101 import PackedVideoDataset

        self._h = None
        self._lib = _load()
        ds = PackedVideoDataset(pack_dir)
        self.batch_size = batch_size
        self.n_frame = n_frame
        size, ch = ds.meta["image_size"], ds.meta["channels"]
        self.clip_shape = (batch_size, n_frame, size, size, ch)
        # gl_open copies the index; the arrays only have to live through it
        index = [np.ascontiguousarray(a, np.int64)
                 for a in (ds.offsets, ds.lengths, ds.labels)]
        as_p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        self._h = self._lib.gl_open(
            os.path.join(pack_dir, "frames.u8").encode(), *map(as_p, index),
            len(ds), n_frame, batch_size, size, size, ch, n_threads, seed,
            start_batch)
        if not self._h:
            raise ValueError(
                f"native loader failed to open {pack_dir} (missing files or no "
                f"video has >= {n_frame} frames)")
        self._clips = np.empty(self.clip_shape, np.float32)
        self._labels = np.empty((batch_size,), np.int64)

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        """The stream's next batch, in arrays of the caller's own."""
        if not self._h:
            raise RuntimeError("native loader is closed")
        rc = self._lib.gl_next(
            self._h,
            self._clips.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc != 0:
            raise RuntimeError("native loader stopped")
        return self._clips.copy(), self._labels.copy()

    def iterate(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next()

    def close(self):
        """Stop the worker threads and unmap the pack; idempotent."""
        if self._h:
            h, self._h = self._h, None
            self._lib.gl_close(h)

    def __del__(self):
        self.close()


class NativeClipSampler:
    """``sample(rng)`` over a :class:`NativeClipLoader`: the runner's clip
    stream with ``data_loader="native"``.

    ``rng`` is accepted for the protocol and ignored, as the JAX facade
    ignores its key: the stream's batch i comes from ``(seed, start_batch +
    i)`` in the C++ ring, and the runner draws its batches in a fixed order,
    so a run and its resume (``start_batch`` = batches consumed before the
    restored step) see the same batches.
    """

    def __init__(self, pack_dir: str, batch_size: int, *, n_frame: int = 16,
                 n_threads: int = 4, seed: int = 0, start_batch: int = 0):
        self._loader = NativeClipLoader(
            pack_dir, batch_size, n_frame=n_frame, n_threads=n_threads,
            seed=seed, start_batch=start_batch)

    def sample(self, rng: Optional[np.random.Generator] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        return self._loader.next()

    def close(self):
        self._loader.close()


class NativeImageSampler:
    """Random single frames through the native ring -> ``(B, H, W, C)``: a
    one-frame window of a video of length L starts uniformly in [0, L - 1],
    as ``UCF101ImageSampler`` picks a uniform video and frame (reference
    dataset/ucf101new.py:169-180). ``rng`` is ignored, as in
    :class:`NativeClipSampler`."""

    def __init__(self, pack_dir: str, batch_size: int, *, n_threads: int = 2,
                 seed: int = 0, start_batch: int = 0):
        self._loader = NativeClipLoader(
            pack_dir, batch_size, n_frame=1, n_threads=n_threads, seed=seed,
            start_batch=start_batch)

    def sample(self, rng: Optional[np.random.Generator] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        clips, labels = self._loader.next()
        return clips[:, 0], labels

    def close(self):
        self._loader.close()
