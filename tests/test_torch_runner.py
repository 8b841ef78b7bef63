"""The port's training loop (``ganode_tpu_torch.train.runner`` and
``python -m ganode_tpu_torch.train``) on the CPU.

The slice as a whole: a tiny ``mnist_ode`` (ngf = ndf = 4, B = 2, T = 6,
d_iters = 2) runs three steps of the JAX runner's loop (batches from the
JAX samplers through ``_stack_d_batches``, keys folded from the step). The
JAX state after the first is carried across (``bridge.gan_state_to_torch``),
and the port's loop body takes the next two with the same batches and the
noise each JAX step drew (``torch_parity.NoiseRecorder``). Losses rtol 1e-5;
every parameter, BatchNorm statistic and Adam moment rtol 1e-4 with the
absolute floors of ``tests/test_torch_train_step.py``. Both sides float32.

The rest pins the behaviour ``tests/test_infra.py`` pins for the JAX runner:
outputs of a run, graceful preemption and a bit-for-bit resume, the STOP
file, the non-finite-loss halt, and the command line.
"""
import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from ganode_tpu.train import runner as jax_runner
from ganode_tpu.utils.config import get_config as jax_get_config
from ganode_tpu_torch import bridge
from ganode_tpu_torch.train import runner
from ganode_tpu_torch.train.__main__ import main
from ganode_tpu_torch.utils import tb
from ganode_tpu_torch.utils.config import get_config
from torch_parity import (NoiseRecorder, assert_bitwise, assert_close_tree,
                          np_tree, to_torch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, DZC = 2, 6, 10
PARITY = dict(batch_size=B, video_length=T, ngf=4, ndf=4, dim_z_content=DZC,
              dim_z_motion=4, d_iters=2)
LOSS_RTOL = 1e-5
RTOL, FLOOR, FLOOR_NU = 1e-4, 1e-5, 1e-4


@pytest.fixture(scope="module")
def jax_steps():
    """Three steps of the JAX runner's loop -> per step (batches, the noise
    the step drew, the state after it, its losses)."""
    config = jax_get_config("mnist_ode", **PARITY)
    trainer = jax_runner.build_trainer(config)
    img_sampler, vid_sampler = jax_runner.build_data(config, synthetic=True)
    key = jax.random.PRNGKey(config.seed)
    with jax.enable_x64(False):
        state = jax.jit(trainer.init_state)(key)
    rec = NoiseRecorder()
    out = []
    with nn.intercept_methods(rec), jax.enable_x64(False):
        step_fn = jax.jit(trainer.train_step)
        for step in range(3):
            k_img, k_vid, k_train = jax.random.split(
                jax.random.fold_in(key, step), 3)
            images = jax_runner._stack_d_batches(img_sampler, k_img,
                                                 config.d_iters)
            videos = jax_runner._stack_d_batches(vid_sampler, k_vid,
                                                 config.d_iters)
            rec.log = []
            state, metrics = step_fn(state, images, videos, k_train)
            jax.block_until_ready(state)
            jax.effects_barrier()
            out.append({"images": images, "videos": videos,
                        "noise": rec.samples(B, T, DZC),
                        "state": np_tree(state), "metrics": np_tree(metrics)})
    return out


def _net_dict(net):
    adam = bridge._adam_state(net.opt_state)
    return {"params": net.params, "batch_stats": net.batch_stats,
            "opt_state": {"count": adam.count, "mu": adam.mu, "nu": adam.nu}}


def test_two_runner_steps_match_two_jax_steps(jax_steps):
    trainer = runner.build_trainer(get_config("mnist_ode", **PARITY),
                                   device="cpu")
    state = trainer.init_state()
    bridge.gan_state_to_torch(jax_steps[0]["state"], state)
    step = runner.make_host_data_step(trainer)
    for want in jax_steps[1:]:
        assert len(want["noise"]) == 6
        metrics = step(state, want["images"], want["videos"], None,
                       noise=to_torch(want["noise"]))
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=LOSS_RTOL, err_msg=k)
    got, want = bridge.torch_gan_state_to_jax(state), jax_steps[-1]["state"]
    assert got["step"] == int(want.step) == 3
    for name in bridge.NETS:
        g, w = got[name], _net_dict(getattr(want, name))
        assert int(g["opt_state"]["count"]) == int(w["opt_state"]["count"])
        for part in ("params", "batch_stats"):
            assert_close_tree(g[part], w[part], RTOL, FLOOR, f"{name}/{part}")
        assert_close_tree(g["opt_state"]["mu"], w["opt_state"]["mu"], RTOL,
                          FLOOR, f"{name}/mu")
        assert_close_tree(g["opt_state"]["nu"], w["opt_state"]["nu"], RTOL,
                          FLOOR_NU, f"{name}/nu")


# ------------------------------------------------------------------ behaviour
def _tiny(name="mnist_ode", **kw):
    base = dict(batch_size=2, video_length=8, ngf=8, ndf=8, dim_z_content=4,
                dim_z_motion=4, d_iters=1, sample_every=0, checkpoint_every=0,
                log_every=1)
    return get_config(name, **{**base, **kw})


def _run(config, workdir, **kw):
    return runner.run_training(config, str(workdir), synthetic=True,
                               device="cpu", **kw)


def test_two_step_synthetic_run_writes_its_outputs(tmp_path):
    wd = tmp_path / "run"
    state, metrics = _run(_tiny(sample_every=2, checkpoint_every=2), wd,
                          steps=2)
    assert state.step == 2 and "preempted" not in metrics
    assert all(np.isfinite(v) for v in metrics.values())
    lines = [json.loads(l) for l in open(wd / "metrics.jsonl")]
    assert [l["step"] for l in lines] == [0, 1]
    assert all(np.isfinite(l["gen_loss"]) and l["clips_per_sec"] > 0
               for l in lines)
    assert sorted(os.listdir(wd / "samples")) == ["gensamples_id0.gif"]
    assert sorted(os.listdir(wd / "checkpoints")) == ["0", "2"]
    (events,) = os.listdir(wd / "tb")
    version, scalars = tb.read_scalars(str(wd / "tb" / events))
    assert version == "brain.Event:2" and [s for s, _ in scalars] == [0, 1]
    assert set(scalars[1][1]) == {"train/gen_loss", "train/dis_img_loss",
                                  "train/dis_vid_loss", "perf/clips_per_sec"}
    assert scalars[1][1]["train/gen_loss"] == pytest.approx(lines[1]["gen_loss"])


def test_samples_are_drawn_in_eval_mode_with_the_ema_weights(tmp_path,
                                                            monkeypatch):
    drawn = []
    monkeypatch.setattr(runner, "save_sample_grid",
                        lambda path, videos, n: drawn.append(videos))
    config = _tiny(ema_decay=0.5)
    trainer = runner.build_trainer(config, device="cpu")
    state = trainer.init_state()
    for p in state.ema_params.values():
        p.zero_()                     # EMA weights that decode to exact zeros
    runner._write_samples(trainer, state, str(tmp_path / "s.gif"), config, n=2)
    assert trainer.gen.training
    state.ema_params = None
    runner._write_samples(trainer, state, str(tmp_path / "raw.gif"), config,
                          n=2)
    ema, raw = drawn
    assert ema.shape == raw.shape == (4, 8, 28, 28, 1)
    assert not ema.any() and raw.any()


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The state after four straight steps of ``_tiny()``, which the
    interrupted-then-resumed runs below must equal bit for bit."""
    state, _ = _run(_tiny(), tmp_path_factory.mktemp("straight"), steps=4)
    return state


def test_preemption_then_resume_equals_an_uninterrupted_run(tmp_path,
                                                            monkeypatch,
                                                            uninterrupted):
    config = _tiny(checkpoint_every=1)
    orig = runner.step_generator

    def preempting(seed, step, stream, device):
        # the loop draws each step's noise generator as the step starts, in
        # the main thread (the batches are drawn ahead, in prefetch's)
        if step == 1 and stream == runner.TRAIN:  # mid step 1
            signal.raise_signal(signal.SIGTERM)
        return orig(seed, step, stream, device)

    monkeypatch.setattr(runner, "step_generator", preempting)
    wd = tmp_path / "pre"
    state, metrics = _run(config, wd, steps=4)
    assert metrics["preempted"] == 2.0 and state.step == 2
    monkeypatch.setattr(runner, "step_generator", orig)
    assert runner.CheckpointManager(str(wd / "checkpoints")).latest_step() == 2

    resumed, m2 = _run(config, wd, steps=4, resume=True)
    assert "preempted" not in m2 and resumed.step == 4
    assert_bitwise(resumed, uninterrupted)
    lines = [json.loads(l) for l in open(wd / "metrics.jsonl")]
    assert [l["step"] for l in lines] == [0, 1, 1, 2, 3]
    assert lines[2]["event"] == "preempted"


def test_stop_file_halts_the_run_and_is_consumed(tmp_path, uninterrupted):
    wd = tmp_path / "run"
    wd.mkdir()
    (wd / "STOP").touch()
    state, metrics = _run(_tiny(), wd, steps=50)
    assert metrics["preempted"] == 1.0 and state.step == 1
    assert not (wd / "STOP").exists()
    resumed, m2 = _run(_tiny(), wd, steps=4, resume=True)
    assert "preempted" not in m2 and resumed.step == 4
    assert_bitwise(resumed, uninterrupted)


def test_a_non_finite_loss_halts_with_a_checkpoint(tmp_path, monkeypatch):
    orig = runner._stack_d_batches
    monkeypatch.setattr(runner, "_stack_d_batches",
                        lambda *a: orig(*a) * np.float32("nan"))
    wd = tmp_path / "nan"
    with pytest.raises(FloatingPointError, match="non-finite loss at step 0"):
        _run(_tiny(), wd, steps=3)
    assert os.listdir(wd / "checkpoints") == ["0"]
    (line,) = [json.loads(l) for l in open(wd / "metrics.jsonl")]
    assert line["event"] == "non_finite_loss"


def test_unported_options_name_their_roadmap_items(tmp_path):
    # every option is ported now; a mesh needs the process group of its
    # ranks (tests/test_torch_runner_mesh.py runs it)
    with pytest.raises(RuntimeError, match="initialised process group"):
        _run(_tiny(mesh="data=2"), tmp_path / "m", steps=1)
    with pytest.raises(SystemExit):
        main(["--config", "mnist_ode", "--cpu", "--mesh", "data=2"])
    # the gradient penalty, once refused (M9), now trains
    state, metrics = _run(_tiny(gp_weight=10.0), tmp_path / "gp", steps=1)
    assert state.step == 1 and all(np.isfinite(v) for v in metrics.values())


# ucf_ode's VideoDiscriminator(ksize=4) takes clips of 16 frames at least
@pytest.mark.parametrize("name,frames", [("mnist_ode", 8), ("ucf_ode", 16)])
def test_the_command_line_trains_on_the_cpu(tmp_path, capsys, name, frames):
    wd = tmp_path / name
    sets = ["--set", "ngf=8", "--set", "ndf=8", "--set",
            f"video_length={frames}", "--set", "d_iters=1"]
    main(["--config", name, "--cpu", "--synthetic", "--steps", "3",
          "--workdir", str(wd), "--batch-size", "2", *sets,
          "--set", "log_every=1", "--set", "sample_every=2"])
    out = capsys.readouterr().out
    assert "done at step 3" in out
    lines = [json.loads(l) for l in open(wd / "metrics.jsonl")]
    assert len(lines) == 3
    assert all(np.isfinite(l[k]) for l in lines
               for k in ("gen_loss", "dis_img_loss", "dis_vid_loss"))
    assert sorted(os.listdir(wd / "samples")) == ["gensamples_id0.gif",
                                                  "gensamples_id2.gif"]
    main(["--config", name, "--cpu", "--synthetic", "--steps", "4",
          "--workdir", str(wd), "--batch-size", "2", "--resume", *sets,
          "--set", "sample_every=0"])
    assert "done at step 4" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--config", name, "--cpu", "--set", "ngf"])


def test_the_command_line_refuses_to_start_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run(
        [sys.executable, "-m", "ganode_tpu_torch.train", "--config",
         "mnist_ode", "--synthetic", "--steps", "1", "--workdir",
         str(tmp_path / "w")], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr and "--cpu" in out.stderr
    assert not (tmp_path / "w").exists()
