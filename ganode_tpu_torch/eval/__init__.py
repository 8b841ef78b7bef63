"""Evaluation: Inception Score, Frechet video distance, feature extractors
(twin of ``ganode_tpu.eval``)."""
from .embedder import (
    ImageClassifier,
    VideoEmbedder,
    apply,
    embed_videos,
    load_params,
    save_params,
    train_classifier,
    train_video_embedder,
)
from .metrics import (
    feature_stats,
    frechet_distance,
    fvd,
    inception_score,
    score_generator,
)

__all__ = [
    "ImageClassifier",
    "VideoEmbedder",
    "apply",
    "embed_videos",
    "feature_stats",
    "frechet_distance",
    "fvd",
    "inception_score",
    "load_params",
    "save_params",
    "score_generator",
    "train_classifier",
    "train_video_embedder",
]
