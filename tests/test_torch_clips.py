"""The port's clip index and clip samplers (``data/clips.py``) held against
the JAX package's (``ganode_tpu/data/clips.py``) on the packs of
``tests/test_data.py::TestClipIndex``, written with the port's
``pack_arrays`` (the format both packages read).

Everything is exact: the windows, the clip locations, the frames and infos
``get_clip`` serves, every batch of ``UCF101SequentialClips``, and the
random sampler's gather on JAX's own picks (``jax.random.randint`` from the
same key, the draw the JAX sampler makes).
"""
import jax
import numpy as np
import pytest

from ganode_tpu.data import clips as jax_clips
from ganode_tpu_torch.data import clips, pack_arrays
from ganode_tpu_torch.data.ucf101 import PackedVideoDataset


def _pack(tmp_path, lengths=(30, 20, 16, 40), size=32, fps=None):
    rng = np.random.RandomState(0)
    videos = [rng.randint(0, 255, (t, size, size, 3), dtype=np.uint8)
              for t in lengths]
    d = str(tmp_path / "pack")
    pack_arrays(d, videos, list(range(len(lengths))), image_size=size,
                source_fps=fps)
    return d, videos


@pytest.mark.parametrize("n,size,step", [(10, 4, 2), (3, 4, 1), (16, 16, 1),
                                         (40, 8, 3)])
def test_unfold_matches_jax(n, size, step):
    idx = np.arange(n) * 2
    np.testing.assert_array_equal(clips.unfold(idx, size, step),
                                  jax_clips.unfold(idx, size, step))


@pytest.mark.parametrize("args", [(20, 4, 4, 30.0, 15.0), (33, 8, 2, 25.0, 10.0),
                                  (16, 16, 1, 30.0, None), (9, 4, 1, 0.0, 12.0)])
def test_compute_clips_for_video_matches_jax(args):
    np.testing.assert_array_equal(clips.compute_clips_for_video(*args),
                                  jax_clips.compute_clips_for_video(*args))


@pytest.mark.parametrize("num_frames,step,frame_rate,fps", [
    (16, 1, None, None), (8, 4, None, None), (8, 8, 15.0, [30.0] * 4),
    (4, 2, 10.0, [25.0, 30.0, 24.0, 30.0])])
def test_clip_index_matches_jax(tmp_path, num_frames, step, frame_rate, fps):
    d, _ = _pack(tmp_path, fps=fps)
    got = clips.ClipIndex(PackedVideoDataset(d), num_frames, step, frame_rate)
    want = jax_clips.ClipIndex(jax_clips.PackedVideoDataset(d), num_frames,
                               step, frame_rate)
    assert got.num_clips() == want.num_clips() > 0
    np.testing.assert_array_equal(got.cumulative, want.cumulative)
    for i in range(got.num_clips()):
        assert got.get_clip_location(i) == want.get_clip_location(i)
        (f, info, v), (wf, winfo, wv) = got.get_clip(i), want.get_clip(i)
        np.testing.assert_array_equal(f, wf)
        assert info == winfo and v == wv
    with pytest.raises(IndexError):
        got.get_clip_location(got.num_clips())


def test_sequential_clips_match_jax(tmp_path):
    d, _ = _pack(tmp_path)
    got = clips.UCF101SequentialClips(d, batch_size=10, num_frames=16)
    want = jax_clips.UCF101SequentialClips(d, batch_size=10, num_frames=16)
    assert len(got) == len(want) == 46
    n = 0
    for (x, y), (wx, wy) in zip(got, want):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
        n += len(x)
    assert n == 46


@pytest.mark.parametrize("host_id,host_count", [(0, 1), (1, 2)])
def test_random_clip_sampler_gathers_what_jax_draws(tmp_path, host_id,
                                                    host_count):
    d, _ = _pack(tmp_path)
    kw = dict(batch_size=4, num_frames=16, host_id=host_id,
              host_count=host_count)
    got = clips.UCF101RandomClipSampler(d, **kw)
    want = jax_clips.UCF101RandomClipSampler(d, **kw)
    np.testing.assert_array_equal(got.eligible, want.eligible)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        pick = np.asarray(jax.random.randint(key, (4,), 0, len(want.eligible)))
        x, y = got.gather(pick)
        wx, wy = want.sample(key)
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
    rng = np.random.default_rng(0)
    x, y = got.sample(rng)
    assert x.shape == (4, 16, 32, 32, 3) and x.min() >= -1 and x.max() <= 1
    a = next(got.iterate(np.random.default_rng(5)))[0]
    assert np.array_equal(a, got.sample(np.random.default_rng(5))[0])


def test_a_host_stripe_without_clips_raises(tmp_path):
    d, _ = _pack(tmp_path, lengths=(16,))
    with pytest.raises(ValueError, match="no clips"):
        clips.UCF101RandomClipSampler(d, 2, num_frames=16, host_id=1,
                                      host_count=2)
