"""``scripts/import_jax_checkpoint.py`` on the committed north-star
checkpoint (``ckpt/wgan128_r4/checkpoints/5551``, ``ucf_wgan_gp_128`` with
the flags it trained with): the port workdir it writes, restored by the
port's ``CheckpointManager``, holds every leaf of the JAX state exactly,
after the bridge's layout rules; and ``generate --workdir`` serves it.
(One EMA clip against JAX's: ``test_torch_import_checkpoint_clip.py``.)
"""
import importlib.util
import os

import jax
import numpy as np
import pytest

from ganode_tpu_torch import bridge, generate
from ganode_tpu_torch.train import build_trainer
from ganode_tpu_torch.utils.checkpoint import CheckpointManager
from ganode_tpu_torch.utils.config import get_config, overrides_from_strings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "ckpt", "wgan128_r4", "checkpoints")
SETS = ["batch_size=32", "compute_dtype=bfloat16", "ema_decay=0.999",
        "diffaug=color,translation,cutout"]


def importer():
    spec = importlib.util.spec_from_file_location(
        "import_jax_checkpoint",
        os.path.join(REPO, "scripts", "import_jax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """(the JAX state, numpy leaves; the port state restored from the
    workdir the script wrote; the workdir)."""
    mod = importer()
    out = tmp_path_factory.mktemp("imported")
    argv = ["--config", "ucf_wgan_gp_128", "--ckpt", CKPT, "--out", str(out)]
    for s in SETS:
        argv += ["--set", s]
    assert mod.main(argv) == 5551
    with pytest.raises(SystemExit, match="already holds"):
        mod.main(argv)
    jax_state, step = mod.restore_jax_state("ucf_wgan_gp_128", SETS, CKPT)
    assert step == 5551
    config = get_config("ucf_wgan_gp_128", **overrides_from_strings(SETS))
    mgr = CheckpointManager(str(out / "checkpoints"))
    assert mgr.all_steps() == [5551]
    state = mgr.restore(build_trainer(config, device="cpu").init_state())
    return jax_state, state, out


def test_leaf_dtypes_are_stated(imported):
    jax_state, _, _ = imported
    assert importer().leaf_dtypes(jax_state) == {"float32": 142, "int32": 4,
                                                 "uint32": 1}
    assert jax_state.ema_params is not None and jax_state.ada is None


@pytest.mark.parametrize("net", bridge.NETS)
def test_every_leaf_of_each_net_is_equal(imported, net):
    """params, batch statistics, spectral-norm ``u`` and Adam's count and
    moments, bit for bit after the layout rules (the bridge's inverse)."""
    jax_state, state, _ = imported
    got = bridge.torch_gan_state_to_jax(state)[net]
    src = getattr(jax_state, net)
    adam = bridge._adam_state(src.opt_state)
    want = {"params": src.params, "batch_stats": src.batch_stats,
            "spectral": src.spectral,
            "opt_state": {"count": adam.count, "mu": adam.mu, "nu": adam.nu}}
    if want["spectral"] is None:
        assert got["spectral"] is None
        del got["spectral"], want["spectral"]
    if not want["batch_stats"]:
        assert not got["batch_stats"]
        del got["batch_stats"], want["batch_stats"]
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))


def test_step_and_ema_are_equal(imported):
    jax_state, state, _ = imported
    got = bridge.torch_gan_state_to_jax(state)
    assert state.step == int(jax_state.step) == 5551
    assert got["ada"] is None
    g = jax.tree_util.tree_leaves_with_path(got["ema_params"])
    w = jax.tree_util.tree_leaves_with_path(jax_state.ema_params)
    assert [p for p, _ in g] == [p for p, _ in w]
    assert len(g) == len(jax.tree_util.tree_leaves(jax_state.gen.params))
    for (p, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))


def test_generate_serves_the_imported_workdir(imported, tmp_path, capsys):
    _, _, out = imported
    npz = tmp_path / "v.npz"
    generate.main(["--config", "ucf_wgan_gp_128", "--workdir", str(out),
                   "--cpu", "--num", "1", "--out", str(npz)])
    assert "restored step 5551" in capsys.readouterr().out
    videos = np.load(npz)["videos"]
    assert videos.shape == (1, 32, 128, 128, 3)
    assert np.isfinite(videos).all() and np.abs(videos).max() <= 1.0
