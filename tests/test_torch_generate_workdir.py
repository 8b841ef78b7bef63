"""The generate CLI serving a training run's workdir, the GIF it writes, and
the ADA controller's state across checkpoints, the bridge and
``build_trainer`` (the port's, against the JAX package's where both exist).

``python -m ganode_tpu_torch.generate --workdir`` mirrors
``scripts/generate.py``: the config's trainer, its initial state, the latest
checkpoint under ``<workdir>/checkpoints`` restored into it (a warning when
there is none), and videos sampled from ``eval_gen_variables``, the EMA
weights when EMA is on. ``--gif`` writes the n x n grid of the first n * n
videos, read back here by the port's own reader and by PIL.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from ganode_tpu.models import PatchImageDiscriminator as JaxPatchImage
from ganode_tpu.models import VideoDiscriminator as JaxVideoD
from ganode_tpu.models import make_generator as jax_make_generator
from ganode_tpu.train import GANTrainer as JaxTrainer
from ganode_tpu.train.runner import build_trainer as jax_build_trainer
from ganode_tpu.utils import config as jax_config
from ganode_tpu_torch import bridge, generate
from ganode_tpu_torch.compat import GeneratorSession
from ganode_tpu_torch.models import (PatchImageDiscriminator,
                                     VideoDiscriminator, make_generator)
from ganode_tpu_torch.train import GANTrainer, build_trainer, run_training
from ganode_tpu_torch.utils import gifs, layout
from ganode_tpu_torch.utils.checkpoint import CheckpointManager
from ganode_tpu_torch.utils.config import get_config, overrides_from_strings
from torch_parity import assert_bitwise

SETS = ["ngf=8", "ndf=8", "batch_size=2", "video_length=8", "d_iters=1",
        "dim_z_content=4", "dim_z_motion=4", "ema_decay=0.9",
        "diffaug=color,translation,cutout", "ada_target=0.6",
        "ada_step=0.1", "r1_weight=0.1"]


def _config(**kw):
    """The config ``SETS`` gives, with ``kw`` over it."""
    return get_config("mnist_ode", **(
        overrides_from_strings(SETS) | kw))


def _cli(*args):
    argv = ["--config", "mnist_ode", "--cpu"]
    for s in SETS:
        argv += ["--set", s]
    return generate.main(argv + list(args))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A workdir after two steps of an augmented ADA + R1 run with EMA."""
    workdir = tmp_path_factory.mktemp("run")
    state, metrics = run_training(_config(), str(workdir), steps=2,
                                  synthetic=True, device="cpu")
    assert {"rt_img", "rt_vid", "ada_p_img", "ada_p_vid"} <= set(metrics)
    return workdir, state


def test_generate_serves_the_runs_ema_weights(trained, tmp_path, capsys):
    workdir, _ = trained
    out, gif = tmp_path / "v.npz", tmp_path / "g.gif"
    _cli("--workdir", str(workdir), "--num", "5", "--batch-size", "3",
         "--seed", "4", "--out", str(out), "--gif", str(gif))
    printed = capsys.readouterr().out
    assert "restored step 2" in printed and "WARNING" not in printed
    videos = np.load(out)["videos"]
    # the same sampling, by hand: the restored state's eval variables
    tr = build_trainer(_config(), device="cpu")
    state = CheckpointManager(str(workdir / "checkpoints")).restore(
        tr.init_state())
    assert state.step == 2 and state.ema_params is not None
    assert state.ada is not None
    variables = tr.eval_gen_variables(state)
    assert any(not torch.equal(variables[k], p)
               for k, p in tr.gen.named_parameters())   # EMA, not raw
    sess = GeneratorSession(tr.gen, variables, seed=4, device="cpu")
    want = np.concatenate([layout.video_from_torch(
        sess.sample_videos(n)[0]).numpy() for n in (3, 2)])
    np.testing.assert_array_equal(videos, want)
    assert videos.shape == (5, 8, 28, 28, 1)
    # a 2 x 2 grid of the first four clips, gray levels exact
    frames = gifs.read_gif(str(gif))
    np.testing.assert_array_equal(
        frames, np.repeat(gifs.video_grid(videos[:4], 2), 3, axis=-1))
    Image = pytest.importorskip("PIL.Image")
    from PIL import ImageSequence
    with Image.open(gif) as im:
        pil = np.stack([np.asarray(f.convert("RGB"))
                        for f in ImageSequence.Iterator(im)])
    np.testing.assert_array_equal(frames, pil)


def test_a_workdir_without_a_checkpoint_warns(tmp_path, capsys):
    out = tmp_path / "v.npz"
    _cli("--workdir", str(tmp_path / "empty"), "--num", "2", "--out",
         str(out))
    assert "WARNING: no checkpoint" in capsys.readouterr().out
    videos = np.load(out)["videos"]
    assert videos.shape == (2, 8, 28, 28, 1) and np.isfinite(videos).all()


def test_workdir_and_weights_exclude_each_other(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        _cli("--workdir", str(tmp_path), "--weights", str(tmp_path / "g.pt"))
    assert e.value.code == 2
    assert "not allowed with argument" in capsys.readouterr().err


def test_read_gif_matches_pil_on_both_writers(tmp_path):
    from ganode_tpu.utils import gifs as jax_gifs
    Image = pytest.importorskip("PIL.Image")
    from PIL import ImageSequence
    rng = np.random.default_rng(0)
    for shape in [(16, 24, 40, 1), (2, 300, 7, 1), (4, 30, 20, 3)]:
        frames = rng.integers(0, 256, shape, dtype=np.uint8)
        for write in (gifs.write_gif, jax_gifs.write_gif):
            path = str(tmp_path / "a.gif")
            write(path, frames)
            with Image.open(path) as im:
                want = np.stack([np.asarray(f.convert("RGB"))
                                 for f in ImageSequence.Iterator(im)])
            np.testing.assert_array_equal(gifs.read_gif(path), want)
    (tmp_path / "x.gif").write_bytes(b"PNG...")
    with pytest.raises(ValueError, match="not a GIF"):
        gifs.read_gif(str(tmp_path / "x.gif"))


# ------------------------------------------------------------ the ADA state
def _ada_state(ada_target, seed=0):
    tr = build_trainer(_config(ada_target=ada_target, seed=seed,
                               diffaug="color"), device="cpu")
    return tr, tr.init_state()


def test_ada_state_is_device_float32_zeros():
    _, state = _ada_state(0.6)
    assert sorted(state.ada) == ["p_img", "p_vid"]
    for p in state.ada.values():
        assert p.dtype == torch.float32 and p.shape == () and float(p) == 0.0
    assert _ada_state(0.0)[1].ada is None


def test_checkpoint_ada_round_trip_and_reconciliation(trained, tmp_path):
    # the trained state with p moved off its start (an untrained D's rt
    # stays below the target, so two steps leave p at 0)
    state = dataclasses.replace(trained[1], ada={
        "p_img": torch.tensor(0.25), "p_vid": torch.tensor(0.75)})
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(2, state)
    # into an ADA state: every tensor back, ada included
    assert_bitwise(mgr.restore(build_trainer(_config(), device="cpu")
                               .init_state()), state)
    # a saved ada into a state built without ADA is loaded
    _, no_ada = _ada_state(0.0)
    restored = mgr.restore(no_ada)
    assert restored.ada is not None
    for k in ("p_img", "p_vid"):
        assert torch.equal(restored.ada[k], state.ada[k])
    # a checkpoint without ada keeps the ADA state's fresh p = 0
    mgr = CheckpointManager(str(tmp_path / "b"))
    mgr.save(1, _ada_state(0.0, seed=1)[1])
    _, fresh = _ada_state(0.6, seed=2)
    restored = mgr.restore(fresh)
    assert {k: float(v) for k, v in restored.ada.items()} == {
        "p_img": 0.0, "p_vid": 0.0}


def _jax_ada_trainer():
    gen = jax_make_generator("ode", n_channels=1, trunk="mnist28",
                             video_length=6, dim_z_content=4, dim_z_motion=4,
                             ngf=4)
    return JaxTrainer(gen=gen, dis_img=JaxPatchImage(ndf=4),
                      dis_vid=JaxVideoD(ksize=2, ndf=4), batch_size=2,
                      diffaug="color", ada_target=0.6)


def _port_trainer(**kw):
    gen = make_generator("ode", n_channels=1, trunk="mnist28", video_length=6,
                         dim_z_content=4, dim_z_motion=4, ngf=4, device="cpu")
    return GANTrainer(gen=gen,
                      dis_img=PatchImageDiscriminator(n_channels=1, ndf=4),
                      dis_vid=VideoDiscriminator(n_channels=1, ndf=4, ksize=2),
                      batch_size=2, **kw)


def test_bridge_carries_the_ada_state_both_ways():
    tr = _jax_ada_trainer()
    with jax.enable_x64(False):
        state = jax.jit(tr.init_state)(jax.random.PRNGKey(0))
    state = state.replace(ada={"p_img": np.float32(0.25),
                               "p_vid": np.float32(0.75)})
    port = _port_trainer(diffaug="color", ada_target=0.6)
    pstate = port.init_state()
    bridge.gan_state_to_torch(state, pstate)
    assert {k: float(v) for k, v in pstate.ada.items()} == {
        "p_img": 0.25, "p_vid": 0.75}
    assert all(v.dtype == torch.float32 for v in pstate.ada.values())
    back = bridge.torch_gan_state_to_jax(pstate)
    assert {k: (v.dtype, v.shape, float(v)) for k, v in back["ada"].items()} \
        == {"p_img": (np.float32, (), 0.25), "p_vid": (np.float32, (), 0.75)}
    # a JAX state without ADA leaves the port state's own
    bridge.gan_state_to_torch(state.replace(ada=None), pstate)
    assert float(pstate.ada["p_vid"]) == 0.75
    plain = _port_trainer().init_state()
    bridge.gan_state_to_torch(state.replace(ada=None), plain)
    assert plain.ada is None
    assert bridge.torch_gan_state_to_jax(plain)["ada"] is None


OVERRIDES = [
    {"diffaug": "color,translation,cutout"},
    {"diffaug": "color,translation,cutout", "ada_target": 0.6,
     "r1_weight": 0.1},
    {"diffaug": "cutout", "ada_target": 0.6, "ada_step": 0.01,
     "ada_p_max": 1.0},
]


@pytest.mark.parametrize("overrides", OVERRIDES,
                         ids=["diffaug", "ada", "ada_p_max"])
def test_build_trainer_passes_the_options_as_jax(overrides):
    small = dict(ngf=4, ndf=4, dim_z_content=4, dim_z_motion=4)
    want = jax_build_trainer(jax_config.get_config("mnist_ode", **small,
                                                   **overrides))
    got = build_trainer(get_config("mnist_ode", **small, **overrides),
                        device="cpu")
    for f in ("diffaug", "ada_target", "ada_step", "ada_p_max", "r1_weight",
              "_diffaug_ops"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.init_state().ada is not None) == (want.ada_target > 0)


@pytest.mark.parametrize("overrides,match", [
    ({"ada_target": 0.6}, "diffaug"),
    ({"diffaug": "color,flip"}, "unknown diffaug op"),
])
def test_bad_options_raise_as_in_jax(overrides, match):
    small = dict(ngf=4, ndf=4)
    with pytest.raises(ValueError, match=match):
        jax_build_trainer(jax_config.get_config("mnist_ode", **small,
                                                **overrides))
    with pytest.raises(ValueError, match=match):
        build_trainer(get_config("mnist_ode", **small, **overrides),
                      device="cpu")


def test_an_ada_step_keeps_p_on_the_device_as_a_tensor():
    """The step reads nothing back: p and the ADA metrics are 0-d tensors,
    and p moves by exactly ada_step per D update (or stays clipped)."""
    tr = _port_trainer(diffaug="color,translation,cutout", ada_target=0.6,
                       ada_step=0.05, d_iters=2)
    state = tr.init_state()
    g = torch.Generator().manual_seed(0)
    metrics = tr.train_step(state, torch.rand((2, 2, 28, 28, 1), generator=g),
                            torch.rand((2, 2, 6, 28, 28, 1), generator=g),
                            generator=g)
    for k in ("rt_img", "rt_vid", "ada_p_img", "ada_p_vid"):
        assert isinstance(metrics[k], torch.Tensor) and metrics[k].shape == ()
    for d in ("img", "vid"):
        p = float(state.ada[f"p_{d}"])
        assert p == float(metrics[f"ada_p_{d}"])
        assert -1.0 <= float(metrics[f"rt_{d}"]) <= 1.0
        assert p in (0.0, np.float32(0.05), np.float32(0.1))
