"""The port's sample-quality metrics (``ganode_tpu_torch/eval/metrics.py``)
held against the JAX package's on seeded arrays, on the CPU.

The host parts (``inception_score``, ``frechet_distance``) run numpy
float64 in both packages: they agree to 1e-10. ``feature_stats`` computes in
the features' dtype (float32 here, JAX under ``enable_x64(False)``), held at
the forward bar rtol 1e-5, atol 1e-6; an FVD of float32 features inherits
that rounding (rtol 1e-5), of float64 features 1e-10.
"""
import jax
import numpy as np
import pytest
import torch

from ganode_tpu.eval import metrics as jm
from ganode_tpu_torch.eval import metrics as tm

HOST_RTOL = 1e-10
RTOL, ATOL = 1e-5, 1e-6


def _probs(rng, n, c):
    logits = rng.standard_normal((n, c)) * 2.0
    p = np.exp(logits - logits.max(1, keepdims=True))
    return p / p.sum(1, keepdims=True)


def _features(seed, n=200, d=16, shift=0.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((d, d)) / np.sqrt(d)
    return (rng.standard_normal((n, d)) @ mix + shift).astype(dtype)


@pytest.mark.parametrize("n,splits", [(100, 10), (37, 10), (50, 1), (8, 3)])
def test_inception_score_matches_jax(n, splits):
    """Equal and ragged splits, numpy and torch inputs."""
    probs = _probs(np.random.default_rng(n), n, 7)
    want = jm.inception_score(probs, splits=splits)
    for given in (probs, torch.from_numpy(probs.astype(np.float32)),
                  probs.astype(np.float32)):
        got = tm.inception_score(given, splits=splits)
        ref = jm.inception_score(np.asarray(given), splits=splits)
        np.testing.assert_allclose(got, ref, rtol=HOST_RTOL, atol=0)
    np.testing.assert_allclose(tm.inception_score(probs, splits=splits), want,
                               rtol=HOST_RTOL, atol=0)


def test_feature_stats_matches_jax():
    feats = _features(1)
    with jax.enable_x64(False):
        mu_j, s_j = (np.asarray(a) for a in jm.feature_stats(feats))
    mu, s = tm.feature_stats(feats)
    assert mu.dtype == s.dtype == torch.float32 and s.shape == (16, 16)
    np.testing.assert_allclose(mu.numpy(), mu_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s.numpy(), s_j, rtol=RTOL, atol=ATOL)
    # the N - 1 normalisation, against numpy's
    np.testing.assert_allclose(s.double().numpy(),
                               np.cov(feats.astype(np.float64), rowvar=False),
                               rtol=1e-5, atol=1e-6)


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((2, 12, 12))
    s1, s2 = a @ a.T / 12, b @ b.T / 12 + np.eye(12) * 0.1
    mu1, mu2 = rng.standard_normal((2, 12))
    want = jm.frechet_distance(mu1, s1, mu2, s2)
    got = tm.frechet_distance(torch.from_numpy(mu1), torch.from_numpy(s1),
                              mu2, s2)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=HOST_RTOL, atol=0)
    # a singular S1 @ S2 (eigenvalues clipped at 0), both packages alike
    s3 = np.outer(mu1, mu1)
    np.testing.assert_allclose(tm.frechet_distance(mu1, s3, mu2, s2),
                               jm.frechet_distance(mu1, s3, mu2, s2),
                               rtol=HOST_RTOL, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fvd_matches_jax(dtype):
    real, fake = _features(3, dtype=dtype), _features(4, shift=0.3,
                                                      dtype=dtype)
    with jax.enable_x64(dtype == np.float64):
        want = jm.fvd(real, fake)
    got = tm.fvd(torch.from_numpy(real), torch.from_numpy(fake))
    rtol = HOST_RTOL if dtype == np.float64 else RTOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    assert want > 1.0
    assert abs(tm.fvd(real, real)) < 1e-3


def test_score_generator_matches_jax():
    """The batch loop: 53 samples in batches of 10 (a ragged last one), the
    sampler's batches identical on both sides (JAX's key and the port's
    generator ignored), and the port's generator handed to every batch."""
    pool = _probs(np.random.default_rng(5), 53, 6)

    def taker():
        done = [0]

        def take(n):
            done[0] += n
            return pool[done[0] - n:done[0]]
        return take

    take_j, take_t, seen = taker(), taker(), []
    want = jm.score_generator(lambda key, n: take_j(n), lambda x: x,
                              n_samples=53, batch_size=10)

    def sample_fn(generator, n):
        seen.append((generator, n))
        return torch.from_numpy(take_t(n))

    got = tm.score_generator(sample_fn, lambda x: x, n_samples=53,
                             batch_size=10, generator=7)
    np.testing.assert_allclose(got, want, rtol=HOST_RTOL, atol=0)
    assert [n for _, n in seen] == [10, 10, 10, 10, 10, 3]
    gens = {id(g) for g, _ in seen}
    assert len(gens) == 1
    assert seen[0][0].initial_seed() == 7


def test_score_generator_draws_from_its_generator():
    """A sampler that draws: the same seed gives the same score, another
    seed another; a passed ``torch.Generator`` is used as it stands."""
    def sample_fn(generator, n):
        return torch.softmax(torch.randn((n, 5), generator=generator) * 3, -1)

    kw = dict(n_samples=40, batch_size=16)
    a = tm.score_generator(sample_fn, lambda x: x, generator=3, **kw)
    b = tm.score_generator(sample_fn, lambda x: x,
                           generator=torch.Generator().manual_seed(3), **kw)
    c = tm.score_generator(sample_fn, lambda x: x, generator=4, **kw)
    assert a == b and a != c
