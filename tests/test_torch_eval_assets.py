"""The feature-model files both packages share (``eval_assets/``), the port's
flax-msgpack codec (``ganode_tpu_torch/utils/flax_msgpack.py``) and its
``load_params`` / ``save_params``, and the synthetic moving-shapes reals,
held against flax and the JAX package on the CPU.

The codec must read every committed asset exactly as flax's
``msgpack_restore`` does and write the bytes flax writes, so that
``evaluate``'s ``asset_hashes`` and scores stay comparable across the two
packages. The committed nets' forwards are held at the conv bar (rtol 1e-4,
atol 1e-5), float32 on both sides.
"""
import glob
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ganode_tpu.eval import embedder as jemb
from ganode_tpu_torch.data import synthetic_moving_shapes
from ganode_tpu_torch.eval import embedder as emb
from ganode_tpu_torch.utils import flax_msgpack
from torch_parity import uniform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = sorted(glob.glob(os.path.join(REPO, "eval_assets", "*", "*.msgpack")))
RTOL, ATOL = 1e-4, 1e-5


def _demo_script():
    spec = importlib.util.spec_from_file_location(
        "demo_tpu_train", os.path.join(REPO, "scripts", "demo_tpu_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_all_six_assets_are_committed():
    assert [os.path.relpath(p, REPO) for p in ASSETS] == [
        "eval_assets/rotmnist/classifier_c10.msgpack",
        "eval_assets/rotmnist/embedder_c10.msgpack",
        "eval_assets/ucf101/classifier_c8_s128.msgpack",
        "eval_assets/ucf101/classifier_c8_s64.msgpack",
        "eval_assets/ucf101/embedder_c64_s128.msgpack",
        "eval_assets/ucf101/embedder_c64_s64.msgpack"]


@pytest.mark.parametrize("path", ASSETS, ids=os.path.basename)
def test_codec_reads_each_asset_as_flax_does(path):
    """Leaf by leaf, exactly (paths, dtypes, shapes, values); written back,
    the file's own bytes."""
    with open(path, "rb") as f:
        data = f.read()
    got = flax_msgpack.loads(data)
    want = serialization.msgpack_restore(data)
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))
    assert flax_msgpack.dumps(got) == data


def test_codec_writes_what_flax_writes():
    """Every header form of the subset (maps of 16+ keys, keys of 32+
    bytes, payloads past 255 and 65,535 bytes; 0-d, empty, integer and
    float16 arrays, numpy scalars) encodes to flax's own bytes and reads
    back."""
    rng = np.random.default_rng(0)
    tree = {f"k{i:02d}": rng.standard_normal(i + 1).astype(np.float32)
            for i in range(17)}
    tree["a" * 40] = {"z": np.arange(300).reshape(3, 100),
                      "y": np.zeros((), np.float64),
                      "e": np.ones((2, 0), np.float16),
                      "s": np.float32(3), "n": np.int32(-70000),
                      "big": np.zeros(70000, np.uint8)}
    data = flax_msgpack.dumps(flax_msgpack.sort_keys(tree))
    assert data == serialization.msgpack_serialize(tree)
    back = flax_msgpack.loads(data)
    assert type(back["a" * 40]["s"]) is np.float32
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    with pytest.raises(TypeError, match="params tree"):
        flax_msgpack.dumps({"w": 1.5})


def test_codec_refuses_what_it_does_not_cover():
    import msgpack  # the JAX package's dependency, here only to build inputs
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True,
                                   "shape": {"0": 1}, "chunks": {}}})
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.loads(chunked)
    bf16 = serialization.msgpack_serialize(
        {"w": jnp.zeros((2,), jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        flax_msgpack.loads(bf16)
    with pytest.raises(ValueError, match="after the msgpack value"):
        flax_msgpack.loads(flax_msgpack.dumps({"a": np.zeros(2)}) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(flax_msgpack.dumps({"a": np.zeros(4)})[:-3])
    with pytest.raises(ValueError, match="extension type 2"):
        flax_msgpack.loads(serialization.msgpack_serialize({"c": 1 + 2j}))


def test_save_params_writes_flax_bytes_that_flax_loads(tmp_path):
    """A port classifier's params, saved: the bytes flax's ``save_params``
    writes for the same tree, loaded by flax's ``load_params`` into its
    template and by the port's into the port's."""
    model, params, _ = emb.train_classifier(
        np.zeros((2, 12, 12, 3), np.float32), np.zeros(2, np.int64),
        n_classes=4, steps=0, seed=3, device="cpu")
    path = emb.save_params(str(tmp_path / "sub" / "cls.msgpack"), params)
    with jax.enable_x64(False):
        template = jax.jit(jemb.ImageClassifier(n_classes=4).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 12, 12, 3)))["params"]
        flax_loaded = jemb.load_params(path, template)
        flax_path = jemb.save_params(str(tmp_path / "flax.msgpack"),
                                     flax_loaded)
    with open(path, "rb") as a, open(flax_path, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(
        np.asarray(flax_loaded["Dense_0"]["kernel"]),
        params["Dense_0.weight"].numpy().T)
    back = emb.load_params(path, params)
    for k in params:
        assert torch.equal(back[k], params[k]), k


def test_load_params_refuses_another_net(tmp_path):
    _, params, _ = emb.train_classifier(
        np.zeros((2, 12, 12, 1), np.float32), np.zeros(2, np.int64),
        n_classes=4, steps=0, device="cpu")
    path = os.path.join(REPO, "eval_assets", "rotmnist",
                        "classifier_c10.msgpack")
    with pytest.raises(ValueError, match="shape"):
        emb.load_params(path, params)        # 12x12 template, 28x28 file
    _, vparams, _ = emb.train_video_embedder(
        np.zeros((2, 2, 8, 8, 1), np.float32), np.zeros(2, np.int64),
        n_classes=3, steps=0, device="cpu")
    with pytest.raises(ValueError, match="differ"):
        emb.load_params(path, vparams)


@pytest.mark.parametrize("asset,shape,video", [
    ("rotmnist/classifier_c10", (28, 28, 1), False),
    ("rotmnist/embedder_c10", (16, 28, 28, 1), True),
    ("ucf101/classifier_c8_s64", (64, 64, 3), False),
    ("ucf101/embedder_c64_s128", (4, 24, 24, 3), True),
])
def test_committed_nets_match_jax(asset, shape, video):
    """The committed feature models, loaded by each package into its own
    template, on a few seeded inputs in [-1, 1]."""
    path = os.path.join(REPO, "eval_assets", f"{asset}.msgpack")
    x = uniform(np.random.default_rng(7), 3, *shape)
    n_classes = int(asset.split("_c")[1].split("_")[0])
    with jax.enable_x64(False):
        if video:
            jmodel, jp, _ = jemb.train_video_embedder(
                x, np.zeros(3, np.int64), n_classes=n_classes, steps=0)
            jp = jemb.load_params(path, jp)
            want = jemb.embed_videos(jmodel, jp, x, batch_size=2)
        else:
            jmodel, jp, _ = jemb.train_classifier(
                x, np.zeros(3, np.int64), n_classes=n_classes, steps=0)
            jp = jemb.load_params(path, jp)
            want = np.asarray(jax.nn.softmax(
                jmodel.apply({"params": jp}, jnp.asarray(x)), axis=-1))
    if video:
        model, params, _ = emb.train_video_embedder(
            x, np.zeros(3, np.int64), n_classes=n_classes, steps=0,
            device="cpu")
        params = emb.load_params(path, params)
        got = emb.embed_videos(model, params, x, batch_size=2)
    else:
        model, params, _ = emb.train_classifier(
            x, np.zeros(3, np.int64), n_classes=n_classes, steps=0,
            device="cpu")
        params = emb.load_params(path, params)
        got = torch.softmax(emb.apply(model, params, x), -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,T,size,seed", [(6, 5, 64, 0), (3, 4, 128, 1),
                                           (4, 3, 40, 2)])
def test_synthetic_moving_shapes_equals_jax_bit_for_bit(n, T, size, seed):
    want_v, want_l = _demo_script().synthetic_moving_shapes(n, T, size=size,
                                                            seed=seed)
    got_v, got_l = synthetic_moving_shapes(n, T, size=size, seed=seed)
    assert got_v.dtype == want_v.dtype and got_l.dtype == want_l.dtype
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_l, want_l)
