"""The port's eval nets and their trainers (``ganode_tpu_torch/eval/
embedder.py``) held against the JAX package's on the CPU.

The forwards run float32 on both sides (JAX under ``enable_x64(False)``),
held at the conv bar (rtol 1e-4, atol 1e-5). The two packages initialise
differently, so the port is given JAX's initial params through the bridge,
and JAX's batch indices (``randint(fold_in(key, i))``, rebuilt with JAX's
own calls in the same x64 mode) as its explicit ``indices``.

The trainers are held in float64 data on both sides (JAX under x64
computes in float64, its params stored float32; the port trains float64
weights), params after 3 Adam steps at rtol 1e-4 with a floor of 1e-5 of
each leaf's largest magnitude. In float32 the two packages' params differ by
up to 6.9e-5 on 2 of the classifier's 131,072 ``Dense_0`` weights after 3
steps (measured): gradients that cancel to ~1e-8, where Adam divides by
|g| + 1e-8 and turns float32 rounding of the sum into steps of order lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu.eval import embedder as jemb
from ganode_tpu_torch import bridge
from ganode_tpu_torch.eval import embedder as emb
from ganode_tpu_torch.models import _on_device
from torch_parity import assert_close_tree, np_tree, uniform

RTOL, ATOL = 1e-4, 1e-5
STEP_RTOL, STEP_FLOOR = 1e-4, 1e-5


def _flax_init(module, shape, seed=0):
    with jax.enable_x64(False):
        return np_tree(jax.jit(module.init)(jax.random.PRNGKey(seed),
                                            jnp.zeros((1,) + shape))["params"])


def _flax_apply(module, params, x):
    with jax.enable_x64(False):
        return np.asarray(module.apply({"params": params}, jnp.asarray(x)))


def _port(build, params):
    """A port net holding the flax ``params``, strictly loaded."""
    model = _on_device(build, 0, "cpu")
    model.load_state_dict(bridge.jax_to_torch({"params": params}), strict=True)
    return model.eval()


def _jax_indices(seed, steps, batch_size, n, x64=False):
    with jax.enable_x64(x64):
        key = jax.random.PRNGKey(seed)
        return np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(key, i), (batch_size,), 0, n))
            for i in range(steps)])


@pytest.mark.parametrize("shape", [(28, 28, 1), (27, 27, 1), (32, 32, 3)])
def test_image_classifier_matches_flax(shape):
    """Even and odd sizes: flax's SAME padding at stride 2 pads (0, 1) on
    an even size and (1, 1) on an odd one."""
    params = _flax_init(jemb.ImageClassifier(n_classes=5), shape)
    x = uniform(np.random.default_rng(1), 4, *shape)
    want = _flax_apply(jemb.ImageClassifier(n_classes=5), params, x)
    model = _port(lambda: emb.ImageClassifier(5, shape), params)
    got = emb.apply(model, emb.params_of(model), x)
    assert got.shape == (4, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(7, 32, 32, 3), (4, 27, 27, 1)])
def test_video_embedder_matches_flax(shape):
    """T pads (1, 1) at stride 1; H and W as the image net's."""
    params = _flax_init(jemb.VideoEmbedder(feature_dim=8), shape)
    x = uniform(np.random.default_rng(2), 3, *shape)
    want = _flax_apply(jemb.VideoEmbedder(feature_dim=8), params, x)
    model = _port(lambda: emb.VideoEmbedder(8, shape[-1]), params)
    got = emb.apply(model, emb.params_of(model), x)
    assert got.shape == (3, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,k,s,want", [(28, 3, 2, (0, 1)), (27, 3, 2, (1, 1)),
                                        (7, 3, 1, (1, 1)), (1, 3, 2, (1, 1)),
                                        (8, 1, 2, (0, 0))])
def test_same_padding_is_xlas_rule(n, k, s, want):
    assert emb.same_padding(n, k, s) == want


def test_image_classifier_flattens_channels_last():
    """``Dense_0``'s rows run (h, w, c), as flax's reshape of an NHWC map:
    with one row of the flax kernel set, the port reads the same feature,
    and the same row read as (c, h, w) would be another feature."""
    shape = (8, 8, 1)
    params = _flax_init(jemb.ImageClassifier(n_classes=3), shape)
    kernel = np.zeros_like(params["Dense_0"]["kernel"])
    row = (1 * 2 + 0) * 64 + 5          # (h=1, w=0, c=5) of the 2x2x64 map
    kernel[row] = 1.0
    params["Dense_0"]["kernel"] = kernel
    x = uniform(np.random.default_rng(3), 4, *shape)
    want = _flax_apply(jemb.ImageClassifier(n_classes=3), params, x)
    model = _port(lambda: emb.ImageClassifier(3, shape), params)
    got = emb.apply(model, emb.params_of(model), x).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the feature Dense_0 reads, from the port's own conv stack
    with torch.no_grad():
        h = torch.from_numpy(x).permute(0, 3, 1, 2)
        for conv in (model.Conv_0, model.Conv_1):
            h = torch.relu(emb._conv_same(conv, h))
    assert h.shape[1:] == (64, 2, 2)
    assert not torch.allclose(h[:, 5, 1, 0], h.reshape(4, -1)[:, row])


@pytest.mark.parametrize("net", ["classifier", "embedder", "video_head"])
def test_bridge_round_trips_the_eval_nets(net):
    """flax params -> ``state_dict`` (strict) -> flax params, exactly."""
    jnet, build, shape = {
        "classifier": (jemb.ImageClassifier(n_classes=4),
                       lambda: emb.ImageClassifier(4, (9, 9, 3)), (9, 9, 3)),
        "embedder": (jemb.VideoEmbedder(feature_dim=6),
                     lambda: emb.VideoEmbedder(6, 3), (3, 9, 9, 3)),
        "video_head": (jemb._VideoClassifierHead(feature_dim=6, n_classes=4),
                       lambda: emb._VideoClassifierHead(6, 4, 3), (3, 9, 9, 3)),
    }[net]
    params = _flax_init(jnet, shape)
    model = _port(build, params)
    back = bridge.torch_to_jax(model.state_dict())
    assert list(back) == ["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back["params"],
                           params)


def test_train_classifier_matches_jax():
    """3 Adam steps from JAX's initial params on JAX's index draws: the
    params and the training accuracy."""
    rng = np.random.default_rng(4)
    images = uniform(rng, 12, 14, 14, 1).astype(np.float64)
    labels = rng.integers(0, 5, 12)
    with jax.enable_x64(True):
        _, want, want_acc = jemb.train_classifier(
            images, labels, n_classes=5, steps=3, batch_size=4, seed=0)
    init = _flax_init(jemb.ImageClassifier(n_classes=5), (14, 14, 1))
    _, got, acc = emb.train_classifier(
        images, labels, n_classes=5, steps=3, batch_size=4, seed=0,
        device="cpu", params=bridge.jax_to_torch({"params": init}),
        indices=_jax_indices(0, 3, 4, 12, x64=True))
    assert all(v.dtype == torch.float64 for v in got.values())
    assert_close_tree(bridge.torch_to_jax(got)["params"], np_tree(want),
                      STEP_RTOL, STEP_FLOOR)
    assert acc == pytest.approx(want_acc)


def test_train_video_embedder_matches_jax():
    """The same for the embedder and its head: the embedder's params after
    3 steps and the batched accuracy over min(256, N) clips."""
    rng = np.random.default_rng(5)
    videos = uniform(rng, 6, 4, 12, 12, 3).astype(np.float64)
    labels = rng.integers(0, 4, 6)
    with jax.enable_x64(True):
        jmodel, want, want_acc = jemb.train_video_embedder(
            videos, labels, n_classes=4, feature_dim=8, steps=3,
            batch_size=4, seed=0)
    init = _flax_init(jemb._VideoClassifierHead(feature_dim=8, n_classes=4),
                      (4, 12, 12, 3))
    model, got, acc = emb.train_video_embedder(
        videos, labels, n_classes=4, feature_dim=8, steps=3, batch_size=4,
        seed=0, device="cpu", params=bridge.jax_to_torch({"params": init}),
        indices=_jax_indices(0, 3, 4, 6, x64=True))
    assert isinstance(model, emb.VideoEmbedder) and isinstance(
        jmodel, jemb.VideoEmbedder)
    assert_close_tree(bridge.torch_to_jax(got)["params"], np_tree(want),
                      STEP_RTOL, STEP_FLOOR)
    assert acc == pytest.approx(want_acc)


def test_embed_videos_batches_like_jax():
    """7 clips in batches of 3 (a ragged last batch): each batch's
    features as JAX's, and as one call over all 7."""
    shape = (3, 10, 10, 3)
    params = _flax_init(jemb.VideoEmbedder(feature_dim=5), shape)
    videos = uniform(np.random.default_rng(6), 7, *shape)
    with jax.enable_x64(False):
        want = jemb.embed_videos(jemb.VideoEmbedder(feature_dim=5), params,
                                 videos, batch_size=3)
    model = _port(lambda: emb.VideoEmbedder(5, 3), params)
    got = emb.embed_videos(model, emb.params_of(model), videos, batch_size=3)
    assert isinstance(got, torch.Tensor) and got.shape == (7, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    whole = emb.embed_videos(model, emb.params_of(model), videos, batch_size=7)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_steps_zero_returns_the_untrained_template():
    """``steps=0``: the seeded initial weights, nan accuracy, no training
    (the data is never read: an array of NaNs goes in)."""
    images = np.full((5, 8, 8, 1), np.nan, np.float32)
    model, params, acc = emb.train_classifier(images, np.zeros(5, np.int64),
                                              n_classes=3, steps=0, seed=7,
                                              device="cpu")
    assert np.isnan(acc) and isinstance(model, emb.ImageClassifier)
    again = _on_device(lambda: emb.ImageClassifier(3, (8, 8, 1)), 7, "cpu")
    for k, v in again.state_dict().items():
        assert torch.equal(params[k], v), k
    videos = np.full((3, 2, 8, 8, 3), np.nan, np.float32)
    model, params, acc = emb.train_video_embedder(
        videos, np.zeros(3, np.int64), n_classes=4, feature_dim=6, steps=0,
        device="cpu")
    assert np.isnan(acc) and isinstance(model, emb.VideoEmbedder)
    assert sorted(params) == sorted(f"{m}.{p}" for m in
                                    ("Conv_0", "Conv_1", "Conv_2", "Dense_0")
                                    for p in ("weight", "bias"))
    assert params["Dense_0.weight"].shape == (6, 128)


def test_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        emb.train_classifier(np.zeros((2, 8, 8, 1), np.float32),
                             np.zeros(2, np.int64), steps=0)
