"""Sample-quality metrics: Inception Score and Frechet (FID/FVD) distance
(twin of ``ganode_tpu/eval/metrics.py``).

* ``inception_score(probs)``: exp(E_x KL(p(y|x) || p(y))) with the 10-split
  mean/std protocol (Salimans et al. 2016), in numpy float64.
* ``feature_stats``: mean and N-1 covariance, in torch on the features' own
  device and dtype.
* ``frechet_distance``: ||mu1 - mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^{1/2}) on the
  host in numpy float64, the trace of the square root from the eigenvalues
  of ``S1 @ S2`` exactly as the JAX package computes it (a ``sqrtm`` gives
  another rounding, and the two packages' numbers are meant to agree).

The feature functions are the trainable nets of ``embedder.py``, so an FVD
here tracks relative progress against one persisted embedder, as in JAX.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def _numpy64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def inception_score(probs, splits: int = 10) -> Tuple[float, float]:
    """probs: (N, C) class probabilities (rows sum to 1), numpy or torch.
    Returns (mean, std) of exp(E KL(p(y|x) || p(y))) over ``splits``
    chunks."""
    probs = _numpy64(probs)
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        marginal = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(marginal + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def feature_stats(features) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) features (a tensor, or numpy on the CPU) -> (mu (D,), sigma
    (D, D)) on their device, in their dtype."""
    features = torch.as_tensor(features)
    mu = features.mean(dim=0)
    centered = features - mu
    sigma = centered.T @ centered / (features.shape[0] - 1)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """Frechet distance between two Gaussians, on the host in float64."""
    mu1, mu2 = _numpy64(mu1), _numpy64(mu2)
    sigma1, sigma2 = _numpy64(sigma1), _numpy64(sigma2)
    diff = np.sum((mu1 - mu2) ** 2)
    # Tr((S1 S2)^{1/2}) via the eigenvalues of S1 @ S2 (real, >= 0 up to noise)
    eigs = np.linalg.eigvals(sigma1 @ sigma2)
    tr_sqrt = np.sum(np.sqrt(np.clip(np.real(eigs), 0.0, None)))
    return float(diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_sqrt)


def fvd(real_features, fake_features) -> float:
    """Frechet Video Distance given (N, D) feature matrices from any
    embedder."""
    mu_r, s_r = feature_stats(real_features)
    mu_f, s_f = feature_stats(fake_features)
    return frechet_distance(mu_r, s_r, mu_f, s_f)


def score_generator(
    sample_fn: Callable[[torch.Generator, int], object],
    prob_fn: Callable[[object], object],
    *,
    n_samples: int = 1000,
    batch_size: int = 100,
    generator=None,
    splits: int = 10,
) -> Tuple[float, float]:
    """End-to-end IS: ``sample_fn(generator, n)`` batches from the generator,
    ``prob_fn`` classifies them, ``inception_score`` scores them. Where JAX
    folds the batch offset into its key, the port hands every batch the same
    ``torch.Generator`` (``generator``: one, or a seed, default 0), which
    advances as the batches draw."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(
            0 if generator is None else int(generator))
    all_probs = []
    for i in range(0, n_samples, batch_size):
        n = min(batch_size, n_samples - i)
        all_probs.append(_numpy64(prob_fn(sample_fn(generator, n))))
    return inception_score(np.concatenate(all_probs), splits=splits)
