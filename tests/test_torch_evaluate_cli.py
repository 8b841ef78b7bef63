"""``python -m ganode_tpu_torch.evaluate`` (the twin of ``scripts/
evaluate.py``) on a 2-step tiny ``mnist_ode`` run, on the CPU.

The command's ``eval.json`` is held against the JAX script's, run here on
the assets the port trained and wrote (which the JAX script loads): the
same keys and ``asset_hashes``; the committed assets' hashes are the JAX
script's rule applied to the files. The two packages draw their samples from different generators, so
the scores are held against the port's own tested functions composed in
this process on the same draws, to the 4 digits ``eval.json`` keeps.
"""
import hashlib
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from ganode_tpu_torch import evaluate
from ganode_tpu_torch.eval import (apply, embed_videos, fvd, inception_score,
                                   load_params, train_classifier,
                                   train_video_embedder)
from ganode_tpu_torch.train import build_trainer, run_training, runner
from ganode_tpu_torch.utils.checkpoint import CheckpointManager
from ganode_tpu_torch.utils.config import get_config, overrides_from_strings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "eval_assets")
SETS = ["ngf=8", "ndf=8", "batch_size=4", "video_length=8", "d_iters=1",
        "dim_z_content=4", "dim_z_motion=4", "ema_decay=0.9"]
N, BATCH = 12, 5
JAX_KEYS = ["config", "checkpoint_step", "n_samples", "n_fake_videos",
            "frame_sampling", "asset_hashes", "classifier_train_acc",
            "embedder_train_acc", "inception_score_mean",
            "inception_score_std", "fvd"]


def _config():
    return get_config("mnist_ode", **overrides_from_strings(SETS))


def _argv(workdir, assets, *extra):
    argv = ["--config", "mnist_ode", "--workdir", str(workdir), "--synthetic",
            "--n-samples", str(N), "--batch-size", str(BATCH),
            "--classifier-steps", "2", "--assets-dir", str(assets)]
    for s in SETS:
        argv += ["--set", s]
    return argv + list(extra)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A workdir after two steps of a tiny run with EMA."""
    wd = tmp_path_factory.mktemp("run")
    run_training(_config(), str(wd), steps=2, synthetic=True, device="cpu")
    return wd


@pytest.fixture(scope="module")
def jax_evaluate():
    """The JAX script's ``main``, run with ``argv`` on the CPU (x64 off)
    -> its ``eval.json``."""
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate", os.path.join(REPO, "scripts", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def run(argv, workdir):
        old = sys.argv
        sys.argv = ["evaluate.py"] + argv
        try:
            with jax.enable_x64(False):
                mod.main()
        finally:
            sys.argv = old
        with open(os.path.join(workdir, "eval.json")) as f:
            return json.load(f)
    return run


def _sha256_16(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def test_eval_json_reads_the_committed_assets(workdir, capsys):
    """On the committed rotmnist assets: the keys of JAX's eval.json, and
    the assets' hashes as JAX's script takes them (sha256, 16 hex digits
    of the file)."""
    got = evaluate.main(_argv(workdir, ASSETS, "--cpu"))
    printed = capsys.readouterr().out
    assert "restored checkpoint at step 2" in printed
    assert "loaded classifier from" in printed and "loaded embedder" in printed
    with open(workdir / "eval.json") as f:
        assert json.load(f) == got
    assert list(got) == JAX_KEYS
    assert got["checkpoint_step"] == 2 and got["n_fake_videos"] == N
    assert got["classifier_train_acc"] is None
    assert np.isfinite([got["fvd"], got["inception_score_mean"]]).all()
    assert got["asset_hashes"] == {
        name: _sha256_16(os.path.join(ASSETS, "rotmnist", name))
        for name in ("classifier_c10.msgpack", "embedder_c10.msgpack")}


def test_assets_the_port_trains_are_jaxs_to_load(workdir, tmp_path,
                                                 jax_evaluate, capsys):
    """No assets: the port trains both feature models and saves them in
    flax's format; a second run loads them unchanged; the JAX script (on a
    fresh JAX workdir: its initial generator) loads the same files and
    writes an eval.json with the same keys and hashes."""
    assets = tmp_path / "assets"
    first = evaluate.main(_argv(workdir, assets, "--cpu"))
    assert "trained + saved classifier" in capsys.readouterr().out
    assert first["classifier_train_acc"] is not None
    assert first["embedder_train_acc"] is not None
    files = sorted(os.listdir(assets / "rotmnist"))
    assert files == ["classifier_c10.msgpack", "embedder_c10.msgpack"]
    second = evaluate.main(_argv(workdir, assets, "--cpu"))
    assert "loaded embedder from" in capsys.readouterr().out
    assert second["asset_hashes"] == first["asset_hashes"]
    assert second["fvd"] == first["fvd"]
    jwd = tmp_path / "jax_run"
    want = jax_evaluate(_argv(jwd, assets, "--cpu"), jwd)
    printed = capsys.readouterr().out
    assert "loaded classifier from" in printed and "loaded embedder" in printed
    assert list(want) == list(first) == JAX_KEYS
    assert want["asset_hashes"] == first["asset_hashes"]
    retrained = evaluate.main(_argv(workdir, assets, "--cpu",
                                    "--retrain-assets"))
    assert "trained + saved embedder" in capsys.readouterr().out
    assert retrained["embedder_train_acc"] is not None


def test_result_is_the_tested_functions_composed(workdir):
    """IS and FVD equal the eval functions composed by hand on the same
    draws: real batches, fake chunks and frame indices from the command's
    streams, the committed assets."""
    got = evaluate.main(_argv(workdir, ASSETS, "--cpu"))
    cfg = _config()
    tr = build_trainer(cfg, device="cpu")
    state = CheckpointManager(str(workdir / "checkpoints")).restore(
        tr.init_state())
    assert state.ema_params is not None
    vids, frames, labels = evaluate.real_data(cfg, N, synthetic=True)
    assert vids.shape == (N, 8, 28, 28, 1) and frames.shape == (N, 28, 28, 1)
    assert vids.min() == -1.0 and vids.max() == 1.0     # rescaled to [-1, 1]
    gen = tr.gen.eval()
    gen.load_state_dict(tr.eval_gen_variables(state))
    with torch.no_grad():
        fakes = torch.cat([gen.sample_videos(
            n, generator=runner.step_generator(123, 20_000 + j, 0, "cpu"))[0]
            for j, n in ((0, 5), (5, 5), (10, 2))])
    ix = runner.step_rng(123, 30_000, 0).integers(0, 8, N)
    rot = os.path.join(ASSETS, "rotmnist")
    model, params, _ = train_classifier(frames, labels, n_classes=10,
                                        steps=0, device="cpu")
    params = load_params(os.path.join(rot, "classifier_c10.msgpack"), params)
    probs = torch.softmax(apply(model, params, fakes[np.arange(N), ix]), -1)
    is_mean, is_std = inception_score(probs)
    emb, eparams, _ = train_video_embedder(vids, labels, n_classes=10,
                                           steps=0, device="cpu")
    eparams = load_params(os.path.join(rot, "embedder_c10.msgpack"), eparams)
    value = fvd(embed_videos(emb, eparams, vids, BATCH),
                embed_videos(emb, eparams, fakes, BATCH))
    assert got["inception_score_mean"] == round(is_mean, 4)
    assert got["inception_score_std"] == round(is_std, 4)
    assert got["fvd"] == round(value, 4)


def test_no_checkpoint_warns_and_no_card_refuses(tmp_path, capsys):
    got = evaluate.main(_argv(tmp_path / "empty", ASSETS, "--cpu"))
    assert "WARNING: no checkpoint found" in capsys.readouterr().out
    assert got["checkpoint_step"] is None
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="no CUDA card"):
        evaluate.main(_argv(tmp_path / "empty", ASSETS))
