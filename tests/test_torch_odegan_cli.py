"""``python -m ganode_tpu_torch.train_odegan`` on the CPU: each method on
the synthetic blobs for 2 steps, the DCGAN pair in its dry-run mode, and the
losses file against what ``scripts/train_odegan.py`` writes (its format: the
values differ, since randomness does not cross frameworks). The JAX script
runs in this process (``runpy``), the port's entry point once as a child
process and otherwise through ``main``."""
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

from ganode_tpu_torch import train_odegan
from ganode_tpu_torch.utils.tb import read_scalars

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--synthetic", "--steps", "2", "--batch-size", "8"]


def _losses(workdir, method):
    with open(os.path.join(workdir, f"losses_{method}.json")) as f:
        return json.load(f)


def _check(losses, method, workdir):
    assert [sorted(e) for e in losses] == [["d_loss", "g_loss", "step"]]
    assert losses[0]["step"] == 0
    assert all(np.isfinite(e[k]) for e in losses for k in ("g_loss", "d_loss"))
    (events,) = [f for f in os.listdir(os.path.join(workdir, "tb"))
                 if "tfevents" in f]
    _, scalars = read_scalars(os.path.join(workdir, "tb", events))
    assert scalars == [(0, {f"{method}/g_loss": losses[0]["g_loss"],
                            f"{method}/d_loss": losses[0]["d_loss"]})]


@pytest.fixture(scope="module")
def jax_losses(tmp_path_factory):
    """What the JAX script writes for 2 euler steps."""
    workdir = str(tmp_path_factory.mktemp("jax"))
    argv = sys.argv
    sys.argv = ["train_odegan.py", "--cpu", "--method", "euler",
                "--workdir", workdir] + SMALL
    try:
        runpy.run_path(os.path.join(REPO, "scripts", "train_odegan.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    return _losses(workdir, "euler")


@pytest.mark.parametrize("method", ["adam", "euler", "rk2", "rk4"])
def test_each_method_trains_and_writes_the_scripts_format(tmp_path, method,
                                                          jax_losses, capsys):
    train_odegan.main(["--cpu", "--method", method, "--workdir",
                       str(tmp_path)] + SMALL)
    got = _losses(tmp_path, method)
    assert [sorted(e) for e in got] == [sorted(e) for e in jax_losses]
    assert [e["step"] for e in got] == [e["step"] for e in jax_losses]
    _check(got, method, str(tmp_path))
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == (
        f"done; losses -> {tmp_path}/losses_{method}.json")


def test_the_dcgan_dry_run_as_a_child_process(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "ganode_tpu_torch.train_odegan", "--cpu",
         "--arch", "dcgan", "--method", "euler", "--dry-run", "--batch-size",
         "4", "--workdir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "1 steps in" in out.stdout
    _check(_losses(tmp_path, "euler"), "euler", str(tmp_path))


def test_without_a_card_it_refuses_to_start(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--cpu"):
        train_odegan.main(["--workdir", str(tmp_path)] + SMALL)


def test_a_loss_without_noise_raises():
    gen, disc, _ = train_odegan.build_nets("mlp", 0, "cpu")
    g_loss, _ = train_odegan.make_losses(gen, disc, 2)
    params = {"gen": dict(gen.named_parameters()),
              "dis_img": dict(disc.named_parameters())}
    with pytest.raises(ValueError, match="torch.Generator"):
        g_loss(params, None, None)
