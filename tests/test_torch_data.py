"""The port's data layer held against the JAX package's on the CPU.

Both packages build their datasets with numpy and scipy, so those equal
exactly. The samplers draw with different generators (``jax.random`` there,
``numpy.random.Generator`` here), so the test draws the indices and uniforms
from a JAX key exactly as the JAX sampler does, and holds the port's
``gather`` of them against the JAX ``sample(key)``: exact equality. The same
for the device data step's gather. A pack written by either package must
read the same in the other.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu.data import rotmnist as jax_rotmnist
from ganode_tpu.data import ucf101 as jax_ucf101
from ganode_tpu.train import runner as jax_runner
from ganode_tpu.utils.config import get_config as jax_get_config
from ganode_tpu_torch.data import rotmnist, ucf101
from ganode_tpu_torch.train import runner
from ganode_tpu_torch.utils.config import get_config

B = 4


def _digits(n, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-0.5, 0.5, (n, 28, 28)).astype(np.float32)
    return images, rng.integers(0, 10, n)


@pytest.mark.parametrize("mode", ["normal", "rand-end", "rsre"])
def test_rotate_videos_matches_jax(mode):
    images, labels = _digits(3)
    got = rotmnist.rotate_videos(images, labels, num_frames=5, mode=mode, seed=3)
    want = jax_rotmnist.rotate_videos(images, labels, num_frames=5, mode=mode,
                                      seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        rotmnist.rotate_videos(images, labels, mode="spin")


@pytest.mark.parametrize("suffix", [".npz", ".mat"])
def test_load_rotmnist_matches_jax(tmp_path, suffix):
    X, Y = rotmnist.rotate_videos(*_digits(8), num_frames=4)
    path = str(tmp_path / f"rot{suffix}")
    if suffix == ".npz":
        np.savez(path, X=X, Y=Y)
    else:
        from scipy.io import savemat
        savemat(path, {"X": X, "Y": Y})
    for kw in ({"train": True, "split": 5}, {"train": False, "split": 5},
               {"train": True, "split": 2, "digits": (int(Y[0]), int(Y[3]))}):
        got = rotmnist.load_rotmnist(path, num_frames=4, **kw)
        want = jax_rotmnist.load_rotmnist(path, num_frames=4, **kw)
        assert got[0].shape[1:] == (4, 28, 28, 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="no videos"):
        rotmnist.load_rotmnist(path, num_frames=4, digits=(11,))


def test_synthetic_datasets_match_jax():
    kw = dict(video_length=4, digits=(3, 5))
    for g, w in zip(runner.synthetic_rotmnist(get_config("mnist_ode", **kw),
                                              n_videos=6),
                    jax_runner.synthetic_rotmnist(
                        jax_get_config("mnist_ode", **kw), n_videos=6)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(runner.synthetic_ucf(get_config("ucf_ode", video_length=4),
                                         n_videos=3),
                    jax_runner.synthetic_ucf(
                        jax_get_config("ucf_ode", video_length=4), n_videos=3)):
        np.testing.assert_array_equal(g, w)


def _randint(key, n, high):
    return np.asarray(jax.random.randint(key, (n,), 0, high))


@pytest.mark.parametrize("value_range", [(0.0, 1.0), (-1.0, 1.0)])
def test_rotmnist_gathers_match_jax_samples(value_range):
    X, Y = rotmnist.rotate_videos(*_digits(7), num_frames=4)
    videos = X.reshape(-1, 4, 28, 28, 1)
    key = jax.random.PRNGKey(11)

    jv = jax_rotmnist.RotMNISTVideos(videos, Y, B, value_range=value_range)
    pv = rotmnist.RotMNISTVideos(videos, Y, B, value_range=value_range)
    whole = np.zeros(B, np.int64)  # whole clips start at their first frame
    for g, w in zip(pv.gather(_randint(key, B, 7), whole), jv.sample(key)):
        np.testing.assert_array_equal(g, w)

    ji = jax_rotmnist.RotMNISTImages(videos, Y, B, value_range=value_range)
    pi = rotmnist.RotMNISTImages(videos, Y, B, value_range=value_range)
    k_vid, k_frame = jax.random.split(key)
    got = pi.gather(_randint(k_vid, B, 7), _randint(k_frame, B, 4))
    for g, w in zip(got, ji.sample(key)):
        np.testing.assert_array_equal(g, w)

    rng = np.random.default_rng(0)
    images, labels = pi.sample(rng)
    assert images.shape == (B, 28, 28, 1) and labels.shape == (B,)
    assert pv.sample(rng)[0].shape == (B, 4, 28, 28, 1)


def _videos(lengths, size=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (t, size, size, 3), dtype=np.uint8)
            for t in lengths]


LENGTHS = (5, 9, 3, 12, 7)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_pack_reads_the_same_in_both_packages(tmp_path, writer):
    videos, labels = _videos(LENGTHS), [4, 0, 7, 1, 9]
    pack = (jax_ucf101 if writer == "jax" else ucf101).pack_arrays
    out = pack(str(tmp_path / "pack"), videos, labels, image_size=8, n_frame=4,
               source_fps=[25.0] * 5)
    got, want = ucf101.PackedVideoDataset(out), jax_ucf101.PackedVideoDataset(out)
    assert got.meta == want.meta and len(got) == len(want) == 5
    for name in ("offsets", "lengths", "labels", "frames"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for v, video in enumerate(videos):
        np.testing.assert_array_equal(got.clip(v, 1, 2), video[1:3])
        np.testing.assert_array_equal(got.frame(v, 2), want.frame(v, 2))


@pytest.mark.parametrize("host_id,host_count", [(0, 1), (1, 2)])
def test_ucf101_gathers_match_jax_samples(tmp_path, host_id, host_count):
    n = 32  # enough clips that every start and frame rule is exercised
    out = ucf101.pack_arrays(str(tmp_path / "pack"), _videos(LENGTHS),
                             [4, 0, 7, 1, 9], image_size=8, n_frame=4)
    key = jax.random.PRNGKey(5)
    k_vid, k_u = jax.random.split(key)
    u = np.asarray(jax.random.uniform(k_u, (n,)))

    clips = ucf101.UCF101ClipSampler(out, n, n_frame=4, host_id=host_id,
                                     host_count=host_count)
    jclips = jax_ucf101.UCF101ClipSampler(out, n, n_frame=4, host_id=host_id,
                                          host_count=host_count)
    np.testing.assert_array_equal(clips.eligible, jclips.eligible)
    got = clips.gather(_randint(k_vid, n, len(clips.eligible)), u)
    for g, w in zip(got, jclips.sample(key)):
        np.testing.assert_array_equal(g, w)

    frames = ucf101.UCF101ImageSampler(out, n, host_id=host_id,
                                       host_count=host_count)
    jframes = jax_ucf101.UCF101ImageSampler(out, n, host_id=host_id,
                                            host_count=host_count)
    got = frames.gather(_randint(k_vid, n, len(frames.eligible)), u)
    for g, w in zip(got, jframes.sample(key)):
        np.testing.assert_array_equal(g, w)

    batch, labels = clips.sample(np.random.default_rng(0))
    assert batch.shape == (n, 4, 8, 8, 3) and batch.dtype == np.float32
    assert -1.0 <= batch.min() and batch.max() < 1.0
    assert set(labels) <= {4, 0, 7, 1, 9}
    with pytest.raises(ValueError, match="long enough"):
        ucf101.UCF101ClipSampler(out, n, n_frame=13)


def test_synthetic_ucf_samplers_match_jax():
    kw = dict(video_length=4, batch_size=B)
    jimg, jvid = jax_runner.build_data(jax_get_config("ucf_ode", **kw),
                                       synthetic=True)
    pimg, pvid = runner.build_data(get_config("ucf_ode", **kw), synthetic=True)
    n, t = pimg.videos.shape[:2]
    key = jax.random.PRNGKey(2)
    k1, k2 = jax.random.split(key)
    i = _randint(k1, B, n)
    for g, w in zip(pimg.gather(i, _randint(k2, B, t)), jimg.sample(key)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(pvid.gather(i, _randint(k2, B, t - 4 + 1)), jvid.sample(key)):
        np.testing.assert_array_equal(g, w)


def test_stacked_batches_draw_in_turn_from_one_generator():
    kw = dict(video_length=4, batch_size=B)
    img, _ = runner.build_data(get_config("ucf_ode", **kw), synthetic=True)
    got = runner._stack_d_batches(img, runner.step_rng(0, 3, runner.IMAGES), 2)
    rng = runner.step_rng(0, 3, runner.IMAGES)
    want = np.stack([img.sample(rng)[0], img.sample(rng)[0]])
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[0], got[1])
    other = runner._stack_d_batches(img, runner.step_rng(0, 4, runner.IMAGES), 2)
    assert not np.array_equal(got, other)


class _Capture:
    """A trainer stand-in whose step returns the batches it was given."""
    batch_size = B

    def train_step(self, state, images, videos, *args, **kwargs):
        return state, {"images": images, "videos": videos}


def test_device_data_gather_matches_jax():
    d, n, t = 2, 5, 4
    videos = np.random.default_rng(1).standard_normal(
        (n, t, 6, 6, 1)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    with jax.enable_x64(False):
        step = jax_runner.make_device_data_step(_Capture(), d, t)
        _, want = step(jnp.zeros(()), jnp.asarray(videos), key)
        k_v, k_i, k_f, _ = jax.random.split(key, 4)
        idx = [np.asarray(jax.random.randint(k, (d, B), 0, hi))
               for k, hi in ((k_v, n), (k_i, n), (k_f, t))]
    got_images, got_videos = runner.gather_device_batches(
        torch.from_numpy(videos), *[torch.tensor(i, dtype=torch.long) for i in idx])
    np.testing.assert_array_equal(got_images.numpy(), np.asarray(want["images"]))
    np.testing.assert_array_equal(got_videos.numpy(), np.asarray(want["videos"]))


def test_device_data_step_draws_from_its_generator():
    d, n, t = 2, 5, 4
    videos = torch.randn((n, t, 6, 6, 1), generator=torch.Generator().manual_seed(0))
    seen = {}

    class Trainer:
        batch_size = B

        def train_step(self, state, images, clips, *, generator):
            seen.update(images=images, clips=clips, generator=generator)
            return {"gen_loss": torch.zeros(())}

    g = torch.Generator().manual_seed(4)
    runner.make_device_data_step(Trainer(), d, t)(None, videos, g)
    assert seen["generator"] is g
    g2 = torch.Generator().manual_seed(4)
    idx = [torch.randint(0, hi, (d, B), generator=g2) for hi in (n, n, t)]
    want_images, want_clips = runner.gather_device_batches(videos, *idx)
    assert torch.equal(seen["images"], want_images)
    assert torch.equal(seen["clips"], want_clips)
    assert seen["clips"].shape == (d, B, t, 6, 6, 1)


def test_missing_dataset_raises(tmp_path):
    for name in ("mnist_ode", "ucf_ode"):
        config = get_config(name, data_path=str(tmp_path / "absent"))
        with pytest.raises(FileNotFoundError):
            runner.build_data(config, synthetic=False)


def test_the_native_loader_names_its_roadmap_item(tmp_path):
    # ROADMAP M15a is ported: data_loader="native" builds the C++ ring's
    # samplers (tests/test_torch_runtime.py holds their batches to JAX's)
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler to build the native loader")
    out = ucf101.pack_arrays(str(tmp_path / "pack"), _videos(LENGTHS),
                             [0] * 5, image_size=8, n_frame=4)
    config = get_config("ucf_ode", data_path=out, data_loader="native",
                        video_length=4, batch_size=2, data_loader_threads=2)
    img, vid = runner.build_data(config)
    try:
        assert vid.sample(None)[0].shape == (2, 4, 8, 8, 3)
        assert img.sample(None)[0].shape == (2, 8, 8, 3)
    finally:
        img.close()
        vid.close()
    with pytest.raises(ValueError, match="no video has >= 16 frames"):
        runner.build_data(dataclasses.replace(config, video_length=16))
    config = dataclasses.replace(config, data_loader="python")
    img, vid = runner.build_data(config)
    assert vid.sample(np.random.default_rng(0))[0].shape == (2, 4, 8, 8, 3)
    with pytest.raises(ValueError, match="unknown data_loader"):
        runner.build_data(dataclasses.replace(config, data_loader="fast"))
