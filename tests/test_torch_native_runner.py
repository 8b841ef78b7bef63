"""The training loop through the native loader and ``prefetch``, on the CPU.

``run_training`` with ``data_loader="native"`` takes each step's batches
from ``data/loader.py::prefetch`` over ``step_batches``: the next
``d_iters`` batches of the image stream (seed + 1) and of the clip stream
(seed), which a resume opens at batch ``start_step * d_iters``. The twin of
``tests/test_runtime.py::test_run_training_through_native_loader`` runs a
tiny ``ucf_ode``; a run stopped after 2 steps and resumed to 4 must equal 4
straight steps bit for bit; the batches each step trains on must be the
streams' own, in order; the samplers and the prefetch worker must be gone
however the loop ends. ``prefetch`` itself: order, structure, a worker's
exception raised in the consumer, a stop. ``iterate`` on every sampler.
"""
import shutil
import threading

import numpy as np
import pytest
import torch

from ganode_tpu_torch.data import (ArrayClips, ArrayImages, RotMNISTImages,
                                   RotMNISTVideos, UCF101ClipSampler,
                                   UCF101ImageSampler, pack_arrays, prefetch)
from ganode_tpu_torch.runtime import NativeClipSampler, NativeImageSampler
from ganode_tpu_torch.train import runner
from ganode_tpu_torch.utils.config import get_config
from torch_parity import assert_bitwise

needs_gpp = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ toolchain")


def _pack(tmp_path, lengths=(40, 32, 24, 20)):
    rng = np.random.RandomState(0)
    videos = [rng.randint(0, 255, (t, 64, 64, 3), dtype=np.uint8)
              for t in lengths]
    return pack_arrays(str(tmp_path / "pack"), videos,
                       list(range(len(lengths))))


def _native(pack_dir, **kw):
    base = dict(batch_size=2, data_loader="native", data_loader_threads=2,
                data_path=pack_dir, video_length=16, ngf=8, ndf=8,
                dim_z_content=4, dim_z_motion=4, d_iters=1, sample_every=0,
                checkpoint_every=0, log_every=1, tensorboard=False)
    return get_config("ucf_ode", **{**base, **kw})


def _run(config, workdir, **kw):
    return runner.run_training(config, str(workdir), device="cpu", **kw)


@pytest.fixture
def opened(monkeypatch):
    """The samplers every ``build_data`` of the test returned."""
    seen = []
    build = runner.build_data

    def recording(*a, **kw):
        samplers = build(*a, **kw)
        seen.extend(samplers)
        return samplers

    monkeypatch.setattr(runner, "build_data", recording)
    return seen


def _closed(sampler) -> bool:
    return sampler._loader._h is None


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "prefetch" and t.is_alive()]


@needs_gpp
def test_run_training_through_native_loader(tmp_path, opened):
    """ucf_ode (tiny) trains through data_loader='native': config ->
    build_data -> the native samplers -> prefetch -> train_step; both
    samplers closed at the end."""
    pack_dir = _pack(tmp_path)
    state, metrics = _run(_native(pack_dir), tmp_path / "run", steps=2)
    assert state.step == 2
    assert all(np.isfinite(v) for v in metrics.values())
    assert [type(s) for s in opened] == [NativeImageSampler,
                                        NativeClipSampler]
    assert all(map(_closed, opened)) and not _prefetch_threads()


@needs_gpp
def test_a_native_resume_equals_an_uninterrupted_run(tmp_path, opened):
    pack_dir = _pack(tmp_path)
    config = _native(pack_dir, d_iters=2)
    straight, _ = _run(config, tmp_path / "straight", steps=4)
    wd = tmp_path / "resumed"
    half, _ = _run(config, wd, steps=2)
    assert half.step == 2
    resumed, metrics = _run(config, wd, steps=4, resume=True)
    assert resumed.step == 4 and "preempted" not in metrics
    assert_bitwise(resumed, straight)
    assert all(map(_closed, opened))


@needs_gpp
@pytest.mark.parametrize("start_step", [1, 3])
def test_build_data_opens_the_streams_at_the_resume_batch(tmp_path,
                                                          start_step):
    pack_dir = _pack(tmp_path)
    config = _native(pack_dir, d_iters=2)
    n = start_step * config.d_iters
    straight = runner.build_data(config)
    resumed = runner.build_data(config, start_step=start_step)
    try:
        for a, b in zip(straight, resumed):
            want = [a.sample(None) for _ in range(n + 1)][n]
            got = b.sample(None)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    finally:
        for s in (*straight, *resumed):
            s.close()


@needs_gpp
def test_each_step_trains_on_the_next_batches_of_each_stream(tmp_path,
                                                             monkeypatch):
    """Step s gets batches s*d .. s*d + d - 1 of the image stream (seed + 1,
    threads // 2) and of the clip stream (seed, threads), as tensors."""
    pack_dir = _pack(tmp_path)
    config = _native(pack_dir, d_iters=2, seed=5, data_loader_threads=4)
    seen = []
    make = runner.make_host_data_step

    def recording(trainer):
        step = make(trainer)

        def wrapped(state, images, videos, generator, noise=None):
            seen.append((images, videos))
            return step(state, images, videos, generator, noise)

        return wrapped

    monkeypatch.setattr(runner, "make_host_data_step", recording)
    _run(config, tmp_path / "run", steps=2)
    images = NativeImageSampler(pack_dir, 2, n_threads=2, seed=6)
    clips = NativeClipSampler(pack_dir, 2, n_frame=16, n_threads=4, seed=5)
    try:
        for got_images, got_videos in seen:
            assert isinstance(got_images, torch.Tensor)
            want_i = np.stack([images.sample(None)[0] for _ in range(2)])
            want_v = np.stack([clips.sample(None)[0] for _ in range(2)])
            np.testing.assert_array_equal(got_images.numpy(), want_i)
            np.testing.assert_array_equal(got_videos.numpy(), want_v)
    finally:
        images.close()
        clips.close()
    assert len(seen) == 2


@needs_gpp
def test_samplers_are_closed_after_a_non_finite_loss(tmp_path, monkeypatch,
                                                     opened):
    pack_dir = _pack(tmp_path)
    orig = runner._stack_d_batches
    monkeypatch.setattr(runner, "_stack_d_batches",
                        lambda *a: orig(*a) * np.float32("nan"))
    with pytest.raises(FloatingPointError, match="non-finite loss at step 0"):
        _run(_native(pack_dir), tmp_path / "nan", steps=5)
    assert len(opened) == 2 and all(map(_closed, opened))
    assert not _prefetch_threads()


@needs_gpp
def test_samplers_are_closed_after_a_stop(tmp_path, opened):
    pack_dir = _pack(tmp_path)
    wd = tmp_path / "run"
    wd.mkdir()
    (wd / "STOP").touch()
    state, metrics = _run(_native(pack_dir), wd, steps=50)
    assert metrics["preempted"] == 1.0 and state.step == 1
    assert all(map(_closed, opened)) and not _prefetch_threads()


# --------------------------------------------------------------- prefetch
def test_prefetch_keeps_order_and_structure_on_the_cpu():
    items = [(np.full((2, 3), i, np.float32),
              {"labels": np.arange(i, i + 2), "step": i,
               "t": torch.tensor([float(i)])}) for i in range(7)]
    got = list(prefetch(iter(items), size=2, device="cpu"))
    assert len(got) == 7
    for i, (x, rest) in enumerate(got):
        assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
        assert torch.equal(x, torch.full((2, 3), float(i)))
        assert torch.equal(rest["labels"], torch.arange(i, i + 2))
        assert rest["step"] == i and torch.equal(rest["t"],
                                                 torch.tensor([float(i)]))
    assert not _prefetch_threads()


def test_prefetch_runs_ahead_in_its_own_thread():
    drawn = []

    def source():
        for i in range(10):
            drawn.append((i, threading.current_thread().name))
            yield np.array([i])

    it = prefetch(source(), size=3, device="cpu")
    assert int(next(it)[0]) == 0
    for _ in range(50):                 # the worker fills its queue
        if len(drawn) >= 4:
            break
        threading.Event().wait(0.02)
    assert len(drawn) >= 4 and {name for _, name in drawn} == {"prefetch"}
    assert [int(x[0]) for x in it] == list(range(1, 10))


def test_a_worker_exception_reaches_the_consumer():
    def failing():
        yield np.zeros(2)
        yield np.ones(2)
        raise OSError("disk gone")

    it = prefetch(failing(), size=2, device="cpu")
    assert [float(x[0]) for x in (next(it), next(it))] == [0.0, 1.0]
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    assert not _prefetch_threads()


def test_closing_early_stops_the_worker():
    closed = []

    def endless():
        try:
            i = 0
            while True:
                yield np.array([i])
                i += 1
        finally:
            closed.append(True)

    it = prefetch(endless(), size=2, device="cpu")
    assert [int(next(it)[0]) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert not _prefetch_threads() and closed == [True]


def test_prefetch_refuses_what_it_cannot_do():
    with pytest.raises(ValueError, match="size"):
        prefetch(iter([]), size=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            prefetch(iter([]), size=2)


# ---------------------------------------------------------------- iterate
def _samplers(tmp_path):
    rng = np.random.default_rng(0)
    videos = rng.uniform(0, 1, (6, 8, 4, 4, 1)).astype(np.float32)
    labels = np.arange(6)
    pack = pack_arrays(str(tmp_path / "p"), [
        rng.integers(0, 256, (t, 8, 8, 3), dtype=np.uint8)
        for t in (9, 12, 5)], [3, 1, 2], image_size=8, n_frame=4)
    return [ArrayImages(videos, labels, 3),
            ArrayClips(videos, labels, 3, 4),
            RotMNISTVideos(videos, labels, 3),
            RotMNISTImages(videos, labels, 3, value_range=(-1.0, 1.0)),
            UCF101ClipSampler(pack, 3, n_frame=4),
            UCF101ImageSampler(pack, 3)]


def test_iterate_draws_every_batch_from_the_one_generator(tmp_path):
    for sampler in _samplers(tmp_path):
        it = sampler.iterate(np.random.default_rng(9))
        ref = np.random.default_rng(9)
        for _ in range(4):
            got, want = next(it), sampler.sample(ref)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
