"""The port's native clip loader (``ganode_tpu_torch/runtime``) on the CPU.

Both packages build their own copy of ``clip_loader.cc`` with ``g++`` and
serve batch i from ``(seed, start_batch + i)`` through the same SplitMix64
window choice and the same ``(v - 128) / 128``; so on one pack the port's
batches must equal the JAX package's bit for bit, at any thread count and
``start_batch``, through the loader and through both facades. The rest
are the twins of ``tests/test_runtime.py``'s cases on the port, where the
port's library is built, and what its build does when it cannot build.
Every case skips without ``g++``, as the JAX file does.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ganode_tpu import runtime as jax_runtime
from ganode_tpu_torch.data import pack_arrays
from ganode_tpu_torch.runtime import (NativeClipLoader, NativeClipSampler,
                                      NativeImageSampler, build_library,
                                      native)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    return build_library()


def _pack(tmp_path, lengths=(30, 20, 16, 40)):
    rng = np.random.RandomState(0)
    videos = [rng.randint(0, 255, (t, 64, 64, 3), dtype=np.uint8)
              for t in lengths]
    pack_dir = str(tmp_path / "pack")
    pack_arrays(pack_dir, videos, list(range(len(lengths))))
    return pack_dir, videos


def _batches(loader, n):
    out = [loader.next() for _ in range(n)]
    loader.close()
    return out


def _equal(got, want):
    assert len(got) == len(want)
    for (c1, l1), (c2, l2) in zip(got, want):
        assert c1.dtype == c2.dtype and c1.shape == c2.shape
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(l1, l2)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("seed", [7, 42, 11])
def test_batches_equal_the_jax_loaders(tmp_path, lib, seed, threads):
    pack_dir, _ = _pack(tmp_path)
    for start in (0, 3):
        kw = dict(n_frame=16, n_threads=threads, seed=seed, start_batch=start)
        _equal(_batches(NativeClipLoader(pack_dir, 4, **kw), 3),
               _batches(jax_runtime.NativeClipLoader(pack_dir, 4, **kw), 3))
        kw = dict(n_threads=threads, seed=seed, start_batch=start)
        port = NativeImageSampler(pack_dir, 4, **kw)
        ref = jax_runtime.NativeImageSampler(pack_dir, 4, **kw)
        _equal([port.sample(None) for _ in range(3)],
               [ref.sample(None) for _ in range(3)])
        port.close()
        ref.close()
        kw = dict(n_frame=16, n_threads=threads, seed=seed, start_batch=start)
        port = NativeClipSampler(pack_dir, 4, **kw)
        ref = jax_runtime.NativeClipSampler(pack_dir, 4, **kw)
        _equal([port.sample(None) for _ in range(3)],
               [ref.sample(None) for _ in range(3)])
        port.close()
        ref.close()


def test_build(lib):
    """The library is built from the port's own source into the port's
    ``_build`` directory, its name hashing the source and the flags."""
    path = native.library_path()
    assert lib == str(path) and os.path.exists(lib)
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "ganode_tpu_torch"
    assert native.SOURCE.parent.parent.name == "ganode_tpu_torch"
    assert path.name.startswith("libclip_loader_") and lib.endswith(".so")
    assert build_library() == lib  # built once


def test_an_edited_source_builds_a_new_library(tmp_path, monkeypatch, lib):
    src = tmp_path / "clip_loader.cc"
    src.write_text(native.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    built = build_library()
    assert built != lib and os.path.dirname(built) == str(tmp_path / "_build")
    assert sorted(os.listdir(tmp_path / "_build")) == [os.path.basename(built)]


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    src = tmp_path / "clip_loader.cc"
    src.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        build_library()
    assert "error" in str(err.value) and "clip_loader.cc" in str(err.value)
    assert os.listdir(tmp_path / "_build") == []   # nothing half-written
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build_library()


def test_batches_and_normalization(tmp_path, lib):
    pack_dir, videos = _pack(tmp_path)
    loader = NativeClipLoader(pack_dir, batch_size=8, n_frame=16, seed=7)
    clips, labels = loader.next()
    assert clips.shape == (8, 16, 64, 64, 3)
    assert clips.dtype == np.float32
    assert clips.min() >= -1.0 and clips.max() <= 1.0
    # every clip must be an exact normalized window of some source video
    for c, l in zip(clips, labels):
        u8 = (c * 128.0 + 128.0).astype(np.uint8)
        vid = videos[l]
        assert any(np.array_equal(u8, vid[s:s + 16])
                   for s in range(vid.shape[0] - 15))
    loader.close()


def test_deterministic_across_thread_counts(tmp_path, lib):
    pack_dir, _ = _pack(tmp_path)

    def first_batches(threads, n=3):
        return _batches(NativeClipLoader(pack_dir, batch_size=4, n_frame=16,
                                         n_threads=threads, seed=42), n)

    _equal(first_batches(1), first_batches(4))


def test_short_videos_skipped(tmp_path, lib):
    pack_dir, _ = _pack(tmp_path, lengths=(8, 25))
    loader = NativeClipLoader(pack_dir, batch_size=16, n_frame=16)
    _, labels = loader.next()
    assert np.all(labels == 1)
    loader.close()


def test_no_eligible_videos_raises(tmp_path, lib):
    pack_dir, _ = _pack(tmp_path, lengths=(4, 6))
    with pytest.raises(ValueError, match="no video has >= 16 frames"):
        NativeClipLoader(pack_dir, batch_size=2, n_frame=16)
    with pytest.raises(FileNotFoundError):
        NativeClipLoader(str(tmp_path / "absent"), batch_size=2)


def test_sustained_throughput(tmp_path, lib):
    """Many batches from a ring of 4 threads, without a deadlock."""
    pack_dir, _ = _pack(tmp_path, lengths=(64,) * 8)
    loader = NativeClipLoader(pack_dir, batch_size=16, n_frame=16, n_threads=4)
    for _ in range(50):
        clips, _ = loader.next()
    assert np.isfinite(clips).all()
    loader.close()


def test_start_batch_resumes_exact_stream(tmp_path, lib):
    """A loader opened at start_batch=n serves batches bit-identical to an
    uninterrupted run's batches n, n+1, ... (the runner's resume path)."""
    pack_dir, _ = _pack(tmp_path)
    stream = _batches(NativeClipLoader(pack_dir, batch_size=4, n_frame=16,
                                       seed=11), 5)
    resumed = NativeClipLoader(pack_dir, batch_size=4, n_frame=16, seed=11,
                               start_batch=3)
    _equal(_batches(resumed, 2), stream[3:])


def test_sampler_facades(tmp_path, lib):
    """The facades take the port's sampler protocol, ``sample(rng)``; the
    generator is ignored. Images are single frames of the pack's videos."""
    pack_dir, videos = _pack(tmp_path)

    clips_s = NativeClipSampler(pack_dir, batch_size=4, n_frame=16, seed=1)
    clips, labels = clips_s.sample(np.random.default_rng(0))
    assert clips.shape == (4, 16, 64, 64, 3) and labels.shape == (4,)
    clips_s.close()

    imgs_s = NativeImageSampler(pack_dir, batch_size=4, seed=2)
    frames, flabels = imgs_s.sample(np.random.default_rng(0))
    assert frames.shape == (4, 64, 64, 3)
    for f, l in zip(frames, flabels):
        u8 = (f * 128.0 + 128.0).astype(np.uint8)
        assert any(np.array_equal(u8, fr) for fr in videos[l])
    imgs_s.close()


def test_close_is_idempotent_and_final(tmp_path, lib):
    pack_dir, _ = _pack(tmp_path)
    for s in (NativeClipSampler(pack_dir, 2, n_frame=16),
              NativeImageSampler(pack_dir, 2)):
        s.sample(None)
        s.close()
        s.close()
        with pytest.raises(RuntimeError, match="closed"):
            s.sample(None)


def test_the_data_runtime_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter imports the port's runtime, loader, video,
    synthetic corpus and both pack commands without JAX or ganode_tpu."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import ganode_tpu_torch.runtime, ganode_tpu_torch.data.loader\n"
        "import ganode_tpu_torch.data.video, ganode_tpu_torch.data.synthetic\n"
        "import ganode_tpu_torch.pack_ucf101\n"
        "import ganode_tpu_torch.make_synthetic_ucf101\n"
        "import ganode_tpu_torch.train.runner\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'ganode_tpu')\n"
        "       or m.startswith(('jax.', 'flax.', 'ganode_tpu.'))]\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
