"""The port's video decoding (``ganode_tpu_torch/data/video.py``) against the
JAX package's ``ganode_tpu/data/video.py`` on the same files, on the CPU.

Both call OpenCV the same way and demux AVI audio with the same standard
library code, so every result must be equal exactly: frames, timestamps,
PCM samples, the (video, audio, info) triple, what a truncated or garbage
file gives, the resize geometry and the fps resampling indices. The files
are MJPG ``.avi``s written with ``cv2`` in the test; an audio stream is
grafted onto one with ``tests/test_data.py``'s RIFF helper. The cases are
the twins of ``tests/test_data.py``'s ``TestVideoInfo``, ``TestAviAudio``,
``TestDecodeRobustness``, ``TestResizeGeometry`` and ``TestFpsResampling``.
"""
import numpy as np
import pytest

from ganode_tpu.data import video as jax_video
from ganode_tpu_torch.data import PackedVideoDataset
from ganode_tpu_torch.data import ucf101, video
from test_data import _mux_audio_into_avi

cv2 = pytest.importorskip("cv2")
FPS, RATE, CH, BITS, T = 25, 8000, 2, 16, 20


def _write_avi(path, frames, rng, size=(64, 48), fps=FPS):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, size)
    for _ in range(frames):
        w.write(rng.randint(0, 255, (size[1], size[0], 3), dtype=np.uint8))
    w.release()
    return str(path)


def assert_same(got, want):
    """Equal values of equal types, recursively (arrays by dtype and
    contents)."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k])
    else:
        assert type(got) is type(want) and got == want


def both(name, *args, **kw):
    """``name(*args)`` in the port, held equal to the JAX package's."""
    got = getattr(video, name)(*args, **kw)
    assert_same(got, getattr(jax_video, name)(*args, **kw))
    return got


@pytest.fixture()
def avi(tmp_path):
    return _write_avi(tmp_path / "v.avi", T, np.random.RandomState(0))


@pytest.fixture()
def avi_with_audio(tmp_path, avi):
    t = np.arange(RATE) / RATE  # 1 s, longer than the video
    wave = np.stack([np.sin(2 * np.pi * 440 * t),
                     np.sin(2 * np.pi * 220 * t)], 1)
    pcm = (np.clip(wave, -1, 1) * 32767).astype(np.int16)
    path = str(tmp_path / "muxed.avi")
    _mux_audio_into_avi(avi, path, pcm.tobytes(), RATE, CH, BITS)
    return path, wave.astype(np.float32)


# ----------------------------------------------------------- decode, info
@pytest.mark.parametrize("start,end", [(0, None), (2, 11), (5, 5), (18, 40)])
def test_read_video_matches_jax(avi, start, end):
    frames = both("read_video", avi, start, end)
    n = T - start if end is None else min(end, T - 1) - start + 1
    assert frames.shape == (n, 48, 64, 3) and frames.dtype == np.uint8
    assert both("probe_length", avi) == T and both("probe_fps", avi) == FPS


def test_timestamps(avi):
    pts, fps = both("read_video_timestamps", avi)
    assert fps == 25.0 and pts.shape == (20,) and pts[0] == 0.0
    assert np.all(np.diff(pts) > 0)
    np.testing.assert_allclose(np.diff(pts), 0.04, atol=1e-3)


def test_read_video_with_info(avi):
    vid, audio, info = both("read_video_with_info", avi, start=2, end=11)
    assert vid.shape == (10, 48, 64, 3) and vid.dtype == np.uint8
    assert audio.shape == (0, 0) and info["audio_fps"] is None
    assert info["video_fps"] == 25.0 and info["pts"].shape == (10,)
    np.testing.assert_allclose(info["pts"][0], 2 * 0.04, atol=1e-3)


def test_read_video_with_info_pts_fallback(avi, monkeypatch):
    """A demux count that disagrees with the decode (a corrupt tail) falls
    back to index / fps timestamps, one per returned frame."""
    fake = lambda path: (np.zeros(3, np.float64), 25.0)
    monkeypatch.setattr(video, "read_video_timestamps", fake)
    monkeypatch.setattr(jax_video, "read_video_timestamps", fake)
    vid, _, info = both("read_video_with_info", avi, start=2, end=11)
    assert info["pts"].shape == (vid.shape[0],)
    np.testing.assert_allclose(info["pts"], (2 + np.arange(10)) * 0.04,
                               atol=1e-6)


# ------------------------------------------------------------------ audio
def test_demux_pcm(avi_with_audio):
    path, wave = avi_with_audio
    samples, rate = both("read_avi_pcm_audio", path)
    assert rate == RATE and samples.shape == (CH, RATE)
    assert samples.dtype == np.float32
    # int16 rounding, and the x32767 encode against the /32768 decode
    np.testing.assert_allclose(samples, wave.T, rtol=0, atol=7e-5)


def test_read_video_with_info_returns_trimmed_audio(avi_with_audio):
    path, wave = avi_with_audio
    vid, audio, info = both("read_video_with_info", path, start=2, end=6)
    assert vid.shape == (5, 48, 64, 3) and info["audio_fps"] == RATE
    # frames [2, 6] at 25 fps span [0.08 s, 0.28 s): 1600 samples
    assert audio.shape == (CH, 1600)
    lo = int(round(0.08 * RATE))
    np.testing.assert_allclose(audio, wave.T[:, lo:lo + 1600], rtol=0,
                               atol=7e-5)


def test_compressed_codec_yields_documented_empty(tmp_path):
    base = _write_avi(tmp_path / "b2.avi", T, np.random.RandomState(1))
    path = str(tmp_path / "mp3.avi")
    _mux_audio_into_avi(base, path, b"\xff\xfb" * 512, RATE, CH, BITS,
                        format_tag=0x55)  # MP3
    assert video.read_avi_pcm_audio(path) is None
    assert jax_video.read_avi_pcm_audio(path) is None
    _, audio, info = both("read_video_with_info", path, start=0, end=4)
    assert audio.shape == (0, 0) and info["audio_fps"] is None


def test_non_avi_returns_none(tmp_path):
    p = tmp_path / "not.avi"
    p.write_bytes(b"definitely not a RIFF file" * 4)
    assert video.read_avi_pcm_audio(str(p)) is None
    assert jax_video.read_avi_pcm_audio(str(p)) is None


# ------------------------------------------------------------- robustness
def test_truncated_file_returns_decodable_prefix(tmp_path):
    path = _write_avi(tmp_path / "full.avi", 30, np.random.RandomState(0),
                      size=(320, 240))
    full = both("read_video", path)
    assert full.shape[0] == 30
    cut = tmp_path / "cut.avi"
    blob = open(path, "rb").read()
    cut.write_bytes(blob[:len(blob) // 2])
    part = both("read_video", str(cut))
    assert 0 < part.shape[0] < 30
    np.testing.assert_array_equal(part[:-1], full[:part.shape[0] - 1])
    vframes, audio, _ = both("read_video_with_info", str(cut))
    assert vframes.shape[0] == part.shape[0] and audio.shape == (0, 0)


def test_garbage_file_returns_empty_not_raise(tmp_path):
    p = tmp_path / "garbage.avi"
    p.write_bytes(bytes(range(256)) * 64)
    assert both("read_video", str(p)).shape == (0, 0, 0, 3)
    assert both("probe_length", str(p)) == 0
    assert both("probe_fps", str(p)) == 0.0


def test_pack_skips_corrupt_keeps_truncated_prefix(tmp_path):
    from ganode_tpu.data import ucf101 as jax_ucf101
    from test_torch_ucf_pack import assert_same_pack

    root = tmp_path / "ucf"
    clap = root / "videos" / "Clap"
    clap.mkdir(parents=True)
    (root / "annotations").mkdir()
    rng = np.random.RandomState(1)
    _write_avi(clap / "good.avi", 30, rng, size=(320, 240))
    _write_avi(clap / "trunc.avi", 40, rng, size=(320, 240))
    blob = (clap / "trunc.avi").read_bytes()
    (clap / "trunc.avi").write_bytes(blob[:int(len(blob) * 0.75)])
    (clap / "corrupt.avi").write_bytes(b"\0" * 4096)
    (root / "annotations" / "classInd.txt").write_text("1 Clap\n")
    (root / "annotations" / "trainlist01.txt").write_text(
        "Clap/good.avi 1\nClap/trunc.avi 1\nClap/corrupt.avi 1\n")
    out = ucf101.pack_ucf101(str(root), str(tmp_path / "p"), progress=False)
    assert_same_pack(out, jax_ucf101.pack_ucf101(
        str(root), str(tmp_path / "j"), progress=False))
    ds = PackedVideoDataset(out)
    assert 1 <= len(ds) <= 2
    assert ds.lengths.max() == 30 or ds.lengths.max() < 40


# ---------------------------------------------------- geometry, resampling
@pytest.mark.parametrize("size", [8, 28, 64, 100, 128, 256])
def test_resize_geometry_matches_jax(size):
    both("default_resize_geometry", size)
    video_in = np.random.RandomState(size).randint(
        0, 255, (3, 240, 320, 3), np.uint8)
    out = both("resize_crop", video_in, size)
    assert out.shape == (3, size, size, 3)


def test_reference_recipe():
    assert video.default_resize_geometry(64) == ((64, 85), 10)
    assert video.default_resize_geometry(128) == ((128, 170), 20)
    clip = np.random.RandomState(0).randint(0, 255, (2, 240, 320, 3),
                                            np.uint8)
    both("resize_crop", clip, 64, resize_hw=(70, 90), x_offset=3)


def test_bad_geometry_raises():
    clip = np.zeros((2, 240, 320, 3), np.uint8)
    with pytest.raises(ValueError):
        video.resize_crop(clip, 64, resize_hw=(64, 60))
    with pytest.raises(ValueError):
        video.resize_crop(clip, 64, resize_hw=(60, 100))


@pytest.mark.parametrize("n,src,target", [
    (10, 25.0, None), (7, 0.0, 10.0), (30, 30.0, 15.0), (25, 25.0, 10.0),
    (10, 10.0, 20.0), (0, 25.0, 10.0), (1, 50.0, 10.0), (40, 29.97, 25.0)])
def test_fps_resampling_matches_jax(n, src, target):
    idx = both("resample_frame_indices", n, src, target)
    assert idx.dtype == np.int64
    assert idx.size == 0 or (idx.min() >= 0 and idx.max() <= max(n - 1, 0))


def test_fps_resampling_cases():
    np.testing.assert_array_equal(
        video.resample_frame_indices(10, 25.0, None), np.arange(10))
    np.testing.assert_array_equal(
        video.resample_frame_indices(7, 0.0, 10.0), np.arange(7))
    np.testing.assert_array_equal(
        video.resample_frame_indices(30, 30.0, 15.0), np.arange(0, 30, 2))
    np.testing.assert_array_equal(
        video.resample_frame_indices(25, 25.0, 10.0),
        np.floor(np.arange(10) * 2.5).astype(np.int64))
    idx = video.resample_frame_indices(10, 10.0, 20.0)
    assert len(idx) == 20 and idx.max() <= 9


def test_decoding_without_opencv_raises(monkeypatch, avi):
    """Without cv2 the decoders raise and say why; the module itself
    imports without it."""
    import builtins

    real = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="OpenCV"):
        video.read_video(avi)
