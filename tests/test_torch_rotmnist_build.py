"""The port's rotated-MNIST preparation (``data/rotmnist.py``:
``load_mnist_idx``, ``load_sklearn_digits``, ``build_rotmnist``; ``python -m
ganode_tpu_torch.build_rotmnist``) held against the JAX package's
(``ganode_tpu/data/rotmnist.py``, ``scripts/build_rotmnist.py``) on the
inputs of ``tests/test_data.py``: gzip idx files written by the test, the
procedural squares, scikit-learn's digits. Every comparison is exact: the
arrays, and the ``X`` and ``Y`` of the ``.npz`` files the two commands
write.
"""
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from ganode_tpu.data import rotmnist as jax_rotmnist
from ganode_tpu_torch.build_rotmnist import main
from ganode_tpu_torch.data import rotmnist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_idx(d, n=24, seed=0, prefix="train"):
    """MNIST's idx.gz pair: a 16-byte image header, an 8-byte label one."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    os.makedirs(d, exist_ok=True)
    with gzip.open(os.path.join(d, f"{prefix}-images-idx3-ubyte.gz"), "wb") as f:
        f.write(np.array([2051, n, 28, 28], ">i4").tobytes() + images.tobytes())
    with gzip.open(os.path.join(d, f"{prefix}-labels-idx1-ubyte.gz"), "wb") as f:
        f.write(np.array([2049, n], ">i4").tobytes() + labels.tobytes())
    return images, labels


@pytest.mark.parametrize("split,num", [("train", None), ("train", 10),
                                       ("test", 5)])
def test_load_mnist_idx_matches_jax(tmp_path, split, num):
    prefix = "train" if split == "train" else "t10k"
    raw, raw_labels = _write_idx(str(tmp_path), prefix=prefix)
    got = rotmnist.load_mnist_idx(str(tmp_path), split, num)
    want = jax_rotmnist.load_mnist_idx(str(tmp_path), split, num)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].min() >= -0.5 and got[0].max() <= 0.5
    np.testing.assert_array_equal(got[1], raw_labels[:num])


def test_load_sklearn_digits_matches_jax():
    got = rotmnist.load_sklearn_digits(12, seed=3)
    want = jax_rotmnist.load_sklearn_digits(12, seed=3)
    assert got[0].shape == (12, 28, 28)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode,digits", [("normal", None), ("rsre", (3, 5))])
def test_build_rotmnist_matches_jax(tmp_path, mode, digits):
    _write_idx(str(tmp_path / "mnist"))
    images, labels = rotmnist.load_mnist_idx(str(tmp_path / "mnist"))
    got = rotmnist.build_rotmnist(str(tmp_path / "port.npz"), images, labels,
                                  num_frames=6, mode=mode, seed=2,
                                  digits=digits)
    want = jax_rotmnist.build_rotmnist(str(tmp_path / "jax.npz"), images,
                                       labels, num_frames=6, mode=mode,
                                       seed=2, digits=digits)
    g, w = np.load(got), np.load(want)
    for k in ("X", "Y"):
        np.testing.assert_array_equal(g[k], w[k])
    X, Y = rotmnist.load_rotmnist(got, train=True, split=4, num_frames=6)
    assert X.shape == (min(4, len(g["Y"])), 6, 28, 28, 1)
    if digits:
        assert set(g["Y"]) <= set(digits)


def _script(args, cwd):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                 "build_rotmnist.py"), *args],
                   check=True, env=env, cwd=cwd, capture_output=True,
                   timeout=120)


@pytest.mark.parametrize("source", [["--mnist-dir", "mnist"], ["--synthetic"],
                                    ["--sklearn"]])
def test_the_command_writes_what_the_jax_script_writes(tmp_path, source,
                                                       capsys):
    _write_idx(str(tmp_path / "mnist"), n=12)
    flags = ["--num", "6", "--frames", "4", "--seed", "1", "--mode",
             "rand-end", "--digits", *[str(d) for d in range(10)]]
    src = [s if s != "mnist" else str(tmp_path / "mnist") for s in source]
    main(["--out", str(tmp_path / "port.npz"), *src, *flags])
    assert "wrote" in capsys.readouterr().out
    _script(["--out", str(tmp_path / "jax.npz"), *src, *flags], tmp_path)
    g, w = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert g["X"].shape == (6, 4, 784)
    for k in ("X", "Y"):
        assert g[k].dtype == w[k].dtype
        np.testing.assert_array_equal(g[k], w[k])


def test_the_command_needs_a_source(tmp_path):
    with pytest.raises(SystemExit):
        main(["--out", str(tmp_path / "x.npz")])
