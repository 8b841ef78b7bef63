"""The port's metrics log, TensorBoard writer, GIF writer and checkpoints
(``ganode_tpu_torch.utils``), held against the JAX package's where both
exist and against the behaviour ``tests/test_infra.py`` pins for JAX.

The GIF writer needs no imaging library; PIL, where installed, decodes its
output here. 1-channel frames come back exactly; RGB frames within 25 levels
per channel (the 6 x 6 x 6 palette's half step, 51 / 2 rounded down on
integers). Checkpoints must restore bit for bit.
"""
import json
import shutil
import signal
import threading
import time

import numpy as np
import pytest
import torch

from ganode_tpu.utils import gifs as jax_gifs
from ganode_tpu.utils import tb as jax_tb
from ganode_tpu_torch.train import GracefulStop, build_trainer
from ganode_tpu_torch.utils import gifs, tb
from ganode_tpu_torch.utils.checkpoint import CheckpointManager
from ganode_tpu_torch.utils.config import get_config
from ganode_tpu_torch.utils.metrics import MetricsLogger, Throughput
from torch_parity import assert_bitwise

RGB_STEP = 25


def test_metrics_logger_writes_jsonl(tmp_path, capsys):
    path = str(tmp_path / "m" / "metrics.jsonl")
    logger = MetricsLogger(path, print_every=100)
    logger.log(0, {"gen_loss": torch.tensor(1.5)})
    logger.log(100, {"gen_loss": 1.25, "event": "x"},
               extra={"clips_per_sec": 100.0})
    logger.log(150, {"gen_loss": 1.0})
    logger.close()
    lines = [json.loads(l) for l in open(path)]
    assert [l["step"] for l in lines] == [0, 100, 150]
    assert lines[0]["gen_loss"] == 1.5 and lines[1]["event"] == "x"
    assert lines[1]["clips_per_sec"] == 100.0
    out = capsys.readouterr().out
    assert "step 0: gen_loss 1.5000" in out and "step 150" not in out
    t = Throughput(32, n_chips=2)
    t.start()
    t.update(3)
    time.sleep(0.01)
    assert 0 < t.clips_per_sec_per_chip() < 32 * 3 / 0.01 / 2


def _write_events(module, logdir):
    w = module.EventWriter(str(logdir))
    w.add_scalar("train/gen_loss", 1.5, step=0)
    w.add_scalars({"train/gen_loss": 1.25, "perf/clips_per_sec": 900.0},
                  step=100)
    w.add_scalars({"train/dis_img_loss": -2.0}, step=2 ** 40, wall_time=7.0)
    w.close()
    return w.path


def test_event_files_equal_the_jax_writers(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234567.25)
    got = _write_events(tb, tmp_path / "port")
    want = _write_events(jax_tb, tmp_path / "jax")
    assert got.split("/")[-1] == want.split("/")[-1]
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_event_files_read_back(tmp_path):
    path = _write_events(tb, tmp_path)
    version, events = tb.read_scalars(path)
    assert version == "brain.Event:2"
    assert events == [(0, {"train/gen_loss": 1.5}),
                      (100, {"train/gen_loss": 1.25,
                             "perf/clips_per_sec": 900.0}),
                      (2 ** 40, {"train/dis_img_loss": -2.0})]
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 1
    bad = tmp_path / "bad"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="checksum"):
        tb.read_scalars(str(bad))
    bad.write_bytes(bytes(data[:-3]))
    with pytest.raises(ValueError, match="truncated"):
        tb.read_scalars(str(bad))

    loader = pytest.importorskip(
        "tensorboard.backend.event_processing.event_file_loader")
    loaded = list(loader.EventFileLoader(path).Load())
    assert loaded[0].file_version == "brain.Event:2"
    scalars = {}
    for ev in loaded[1:]:
        for v in ev.summary.value:
            val = v.tensor.float_val[0] if v.tensor.float_val else v.simple_value
            scalars[(ev.step, v.tag)] = val
    assert scalars == {(0, "train/gen_loss"): 1.5,
                       (100, "train/gen_loss"): 1.25,
                       (100, "perf/clips_per_sec"): 900.0,
                       (2 ** 40, "train/dis_img_loss"): -2.0}


def test_video_grid_matches_jax():
    videos = np.random.default_rng(0).uniform(
        -1.2, 1.2, (10, 3, 5, 4, 3)).astype(np.float32)
    for n in (None, 2, 3):
        np.testing.assert_array_equal(gifs.video_grid(videos, n),
                                      jax_gifs.video_grid(videos, n))
    assert gifs.video_grid(videos).shape == (3, 15, 12, 3)
    with pytest.raises(ValueError, match="grid"):
        gifs.video_grid(videos, 4)


def _decode(path):
    Image = pytest.importorskip("PIL.Image")
    from PIL import ImageSequence
    with Image.open(path) as im:
        info = dict(im.info)
        frames = np.stack([np.asarray(f.convert("RGB"))
                           for f in ImageSequence.Iterator(im)])
    return frames, info


@pytest.mark.parametrize("shape", [(16, 24, 40, 1), (3, 1, 1, 1), (2, 300, 7, 1)])
def test_gray_gif_decodes_exactly(tmp_path, shape):
    frames = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    path = gifs.write_gif(str(tmp_path / "g" / "a.gif"), frames, fps=8)
    got, info = _decode(path)
    np.testing.assert_array_equal(got, np.repeat(frames, 3, axis=-1))
    # the same animation as the JAX writer's (PIL): looped, 120 ms frames
    want, want_info = _decode(jax_gifs.write_gif(str(tmp_path / "j.gif"), frames))
    np.testing.assert_array_equal(got, want)
    assert info["loop"] == want_info["loop"] == 0
    assert info["duration"] == want_info["duration"] == 120


def test_rgb_gif_decodes_within_the_palette_step(tmp_path):
    videos = np.random.default_rng(2).uniform(
        -1, 1, (4, 5, 16, 16, 3)).astype(np.float32)
    path = gifs.save_sample_grid(str(tmp_path / "s.gif"), videos, fps=4)
    got, info = _decode(path)
    grid = gifs.video_grid(videos)
    assert got.shape == grid.shape
    assert np.abs(got.astype(int) - grid).max() <= RGB_STEP
    assert info["duration"] == 250
    levels = np.arange(0, 256, 51)
    assert np.isin(got, levels).all()
    with pytest.raises(ValueError, match="uint8"):
        gifs.write_gif(str(tmp_path / "x.gif"), grid.astype(np.float32))
    with pytest.raises(ValueError, match="channels"):
        gifs.write_gif(str(tmp_path / "x.gif"), grid[..., :2])


# ----------------------------------------------------------------- checkpoints
def _trained_state(seed=0, ema_decay=0.9):
    """A tiny trainer after one step: non-zero Adam moments, moved BatchNorm
    statistics and EMA parameters."""
    config = get_config("mnist_ode", ngf=8, ndf=8, batch_size=2, video_length=8,
                        dim_z_content=4, dim_z_motion=4, d_iters=1,
                        ema_decay=ema_decay, seed=seed)
    tr = build_trainer(config, device="cpu")
    state = tr.init_state()
    g = torch.Generator().manual_seed(seed)
    tr.train_step(state, torch.rand((1, 2, 28, 28, 1), generator=g),
                  torch.rand((1, 2, 8, 28, 28, 1), generator=g), generator=g)
    return tr, state


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    _, state = _trained_state()
    assert state.ema_params is not None
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None and mgr.all_steps() == []
    assert mgr.save(1, state)
    assert mgr.latest_step() == 1
    _, fresh = _trained_state(seed=3)
    restored = mgr.restore(fresh)
    assert restored is fresh
    assert_bitwise(restored, state)
    assert not any(n.endswith(".tmp") or ".tmp" in n
                   for n in (p.name for p in (tmp_path / "ckpt" / "1").iterdir()))


def test_relocated_checkpoint_restores_bitwise(tmp_path):
    _, state = _trained_state(seed=5)
    CheckpointManager(str(tmp_path / "worker" / "checkpoints")).save(3, state)
    shutil.copytree(tmp_path / "worker" / "checkpoints" / "3",
                    tmp_path / "fresh" / "checkpoints" / "3")
    shutil.rmtree(tmp_path / "worker")
    mgr = CheckpointManager(str(tmp_path / "fresh" / "checkpoints"))
    assert mgr.latest_step() == 3
    assert_bitwise(mgr.restore(_trained_state(seed=11)[1]), state)


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    (tmp_path / "empty" / "7").mkdir()          # a step with no blob is none
    with pytest.raises(FileNotFoundError):
        mgr.restore(_trained_state()[1])


def test_the_ema_slot_follows_the_checkpoint(tmp_path):
    _, with_ema = _trained_state(ema_decay=0.9)
    _, without = _trained_state(ema_decay=0.0)
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(1, with_ema)
    restored = mgr.restore(_trained_state(seed=2, ema_decay=0.0)[1])
    assert restored.ema_params is not None
    assert_bitwise(restored, with_ema)
    mgr = CheckpointManager(str(tmp_path / "b"))
    mgr.save(1, without)
    restored = mgr.restore(_trained_state(seed=2, ema_decay=0.9)[1])
    assert restored.ema_params is None and restored.ada is None
    assert_bitwise(restored, without)


def test_max_to_keep_and_old_steps(tmp_path):
    _, state = _trained_state(ema_decay=0.0)
    mgr = CheckpointManager(str(tmp_path / "c"), max_to_keep=3)
    for step in (0, 2, 4, 6, 8):
        assert mgr.save(step, state)
    assert mgr.all_steps() == [4, 6, 8]
    assert not (tmp_path / "c" / "0").exists()
    assert not mgr.save(8, state) and not mgr.save(5, state)
    assert mgr.all_steps() == [4, 6, 8]
    assert CheckpointManager(str(tmp_path / "c")).latest_step() == 8


def test_graceful_stop_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with GracefulStop() as stop:
        assert not stop.requested
        signal.raise_signal(signal.SIGTERM)
        assert stop.requested
    assert signal.getsignal(signal.SIGTERM) is before

    seen = []

    def off_main():
        with GracefulStop() as s:
            seen.append(s.requested)

    t = threading.Thread(target=off_main)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and seen == [False]
    assert signal.getsignal(signal.SIGTERM) is before
