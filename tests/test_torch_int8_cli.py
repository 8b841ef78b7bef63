"""The port's serving commands for this slice on the CPU: ``python -m
ganode_tpu_torch.generate --int8`` (twin of ``scripts/generate.py --int8``)
and ``python -m ganode_tpu_torch.import_reference`` (twin of
``scripts/import_reference_checkpoint.py``) feeding ``generate --workdir``.

``generate --int8`` must equal the functions it composes, on the same draws:
``GeneratorSession``'s generator, ``sample_z_video``, ``quantize_trunk`` and
``int8_trunk_apply`` (tested against JAX in ``test_torch_quant.py``). The
reference checkpoint is synthetic (``tests/reference_ckpt.py``).
"""
import numpy as np
import pytest
import torch

from ganode_tpu_torch import generate, import_reference
from ganode_tpu_torch.compat import GeneratorSession
from ganode_tpu_torch.compat_torch import import_gan_state
from ganode_tpu_torch.models import generator_for_config
from ganode_tpu_torch.ops.quant import int8_trunk_apply, quantize_trunk
from ganode_tpu_torch.train import build_trainer
from ganode_tpu_torch.utils import gifs, layout
from ganode_tpu_torch.utils.config import get_config
from reference_ckpt import EPOCH, synthetic_reference

SETS = ["ngf=8", "ndf=8", "batch_size=2", "video_length=8"]
TINY = dict(ngf=8, ndf=8, batch_size=2, video_length=8)


def _cli(main, config, *args):
    argv = ["--config", config]
    for s in SETS:
        argv += ["--set", s]
    return main(argv + list(args))


def _by_hand(config, sess, sizes, video_len=None):
    """``sample_videos_int8`` spelled out: the session's draws, then the int8
    trunk, frames (n*T, C, H, W) back to clips (n, T, H, W, C)."""
    qs = quantize_trunk(config.trunk, sess.gen.main)
    t = video_len or config.video_length
    out = []
    with torch.no_grad():
        for n in sizes:
            z, _ = sess.gen.sample_z_video(n, t, generator=sess.generator)
            frames = int8_trunk_apply(config.trunk, qs, z)
            out.append(frames.reshape(n, t, *frames.shape[1:])
                       .permute(0, 1, 3, 4, 2).numpy())
    return np.concatenate(out)


@pytest.mark.parametrize("name", ["mnist_ode", "ucf_ode"])
def test_generate_int8_equals_its_parts(name, tmp_path, capsys):
    out, gif = tmp_path / "v.npz", tmp_path / "g.gif"
    _cli(generate.main, name, "--cpu", "--int8", "--num", "5",
         "--batch-size", "3", "--seed", "4", "--out", str(out),
         "--gif", str(gif))
    assert "on cpu" in capsys.readouterr().out
    videos = np.load(out)["videos"]
    cfg = get_config(name, **TINY)
    sess = GeneratorSession(generator_for_config(cfg, device="cpu"), seed=4,
                            device="cpu")
    np.testing.assert_array_equal(videos, _by_hand(cfg, sess, (3, 2)))
    size = 28 if name == "mnist_ode" else 64
    assert videos.shape == (5, 8, size, size, cfg.n_channels)
    # the float path on the same draws, within JAX's bars
    sess = GeneratorSession(generator_for_config(cfg, device="cpu"), seed=4,
                            device="cpu")
    want = np.concatenate([layout.video_from_torch(sess.sample_videos(n)[0])
                           .numpy() for n in (3, 2)])
    err = np.abs(videos - want)
    assert err.max() < 0.15 and err.mean() < 0.02
    frames = gifs.read_gif(str(gif))
    grid = gifs.video_grid(videos[:4], 2)
    assert frames.shape == grid.shape[:-1] + (3,)
    if name == "mnist_ode":  # gray levels exact (RGB goes through a palette)
        np.testing.assert_array_equal(frames, np.repeat(grid, 3, axis=-1))


def test_generate_int8_longer_clips(tmp_path):
    out = tmp_path / "v.npz"
    _cli(generate.main, "mnist_ode", "--cpu", "--int8", "--num", "2",
         "--video-len", "12", "--out", str(out))
    videos = np.load(out)["videos"]
    cfg = get_config("mnist_ode", **TINY)
    sess = GeneratorSession(generator_for_config(cfg, device="cpu"), seed=0,
                            device="cpu")
    np.testing.assert_array_equal(videos, _by_hand(cfg, sess, (2,), 12))


def test_generate_int8_refuses_a_gres_trunk(tmp_path):
    with pytest.raises(SystemExit) as e:
        generate.main(["--config", "ucf_gres", "--cpu", "--int8", "--set",
                       "ngf=4", "--num", "1", "--out", str(tmp_path / "v.npz")])
    assert "no int8 geometry for trunk 'gres64'" in str(e.value.code)


def test_the_commands_refuse_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _cli(generate.main, "mnist_ode", "--int8", "--num", "1")
    assert "no CUDA card" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        _cli(import_reference.main, "mnist_ode", "--ckpt",
             str(tmp_path / "c.ckpt"), "--workdir", str(tmp_path / "run"))
    assert "no CUDA card" in str(e.value.code)


@pytest.mark.parametrize("fresh", [False, True])
def test_import_reference_then_generate_workdir(fresh, tmp_path, capsys):
    ckpt, *_ = synthetic_reference("mnist_ode", seed=5, **TINY)
    path, run = tmp_path / "state_normal41000.ckpt", tmp_path / "run"
    torch.save(ckpt, path)
    _cli(import_reference.main, "mnist_ode", "--cpu", "--ckpt", str(path),
         "--workdir", str(run), *(["--fresh-optimizer"] if fresh else []))
    assert f"imported reference step {EPOCH}" in capsys.readouterr().out
    assert (run / "checkpoints" / str(EPOCH) / "state.pt").exists()
    # the same import in this process
    cfg = get_config("mnist_ode", **TINY)
    tr = build_trainer(cfg, device="cpu")
    state = import_gan_state(ckpt, tr.init_state(), cfg,
                             import_optimizer=not fresh)
    assert bool(state.gen.opt.state) != fresh
    for args, int8 in (((), False), (("--int8",), True)):
        out = tmp_path / f"v{int8}.npz"
        _cli(generate.main, "mnist_ode", "--cpu", "--workdir", str(run),
             "--num", "3", "--seed", "2", "--out", str(out), *args)
        assert f"restored step {EPOCH}" in capsys.readouterr().out
        videos = np.load(out)["videos"]
        sess = GeneratorSession(tr.gen, tr.eval_gen_variables(state), seed=2,
                                device="cpu")
        want = (_by_hand(cfg, sess, (3,)) if int8 else
                layout.video_from_torch(sess.sample_videos(3)[0]).numpy())
        np.testing.assert_array_equal(videos, want)
