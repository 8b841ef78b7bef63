"""Evaluate a trained generator: Inception Score + Frechet Video Distance
(twin of ``scripts/evaluate.py``).

  python -m ganode_tpu_torch.evaluate --config mnist_ode --workdir RUN \
      [--data data/rot-mnist.npz] [--n-samples 512] [--batch-size 64] \
      [--classifier-steps 300] [--assets-dir eval_assets] [--retrain-assets] \
      [--set FIELD=VALUE ...] [--synthetic] [--cpu]

Restores the latest checkpoint of the training run in ``RUN`` (the initial
generator, with a warning, when there is none) and samples ``--n-samples``
fake clips from ``eval_gen_variables``, the EMA weights when EMA is on, in
eval mode, ``--batch-size`` per call. IS classifies one uniformly random
frame of each fake clip with a small classifier trained on the real data's
labels; FVD embeds real and fake clips with a video embedder trained to
classify the reals. Both feature models are trained once and persisted in
flax's msgpack format under ``<assets-dir>/<dataset>/``, under the JAX
package's names (``classifier_c10.msgpack`` for rotmnist, pinned to its 10
digits; ``_s<frame size>`` for ucf101), and loaded when present, so the two
packages share the files and ``asset_hashes`` (sha256, first 16 hex digits)
say when two numbers were measured alike. rotmnist reals are rescaled to the
generator's [-1, 1]. Writes ``RUN/eval.json`` with the JAX script's keys.

Where JAX folds an offset into ``PRNGKey(123)``, the port draws from the
runner's numpy and torch generators of ``(123, offset, 0)`` (``step_rng``,
``step_generator``; the same offsets: real batch i at i and 10_000 + i, fake
chunk j at 20_000 + j, the frame indices at 30_000): the numbers match
JAX's in distribution, not digit for digit. The tests
hold the parts against JAX on identical draws. Runs on the CUDA card unless
``--cpu`` is given; with no card and no ``--cpu`` it exits with an error.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

from . import resolve_device
from .eval import (apply, embed_videos, fvd, inception_score, load_params,
                   save_params, train_classifier, train_video_embedder)
from .train.runner import build_data, build_trainer, step_generator, step_rng
from .utils.checkpoint import CheckpointManager
from .utils.config import get_config, overrides_from_strings

SEED = 123
REAL_VIDEOS, REAL_IMAGES, FAKES, FRAMES = 0, 10_000, 20_000, 30_000


def real_data(config, n: int, *, synthetic: bool):
    """-> (videos, frames, labels): ``n`` real clips, one random frame of
    ``n`` other random clips, and the clips' labels, batch by batch from the
    config's samplers; rotmnist rescaled to [-1, 1]."""
    vr = (-1.0, 1.0) if config.dataset == "rotmnist" else None
    img_sampler, vid_sampler = build_data(config, synthetic=synthetic,
                                          value_range=vr)
    videos, frames, labels = [], [], []
    i = 0
    while sum(len(v) for v in videos) < n:
        vids, lab = vid_sampler.sample(step_rng(SEED, REAL_VIDEOS + i, 0))
        videos.append(np.asarray(vids))
        labels.append(np.asarray(lab).reshape(-1))
        imgs, _ = img_sampler.sample(step_rng(SEED, REAL_IMAGES + i, 0))
        frames.append(np.asarray(imgs))
        i += 1
    return (np.concatenate(videos)[:n], np.concatenate(frames)[:n],
            np.concatenate(labels)[:n].astype(np.int64))


@torch.no_grad()
def fake_videos(gen, state_dict, n: int, batch_size: int, device):
    """``n`` clips (n, T, H, W, C) on ``device`` from ``gen`` holding
    ``state_dict``, in eval mode, chunk j from its own generator."""
    gen.load_state_dict(state_dict)
    gen.eval()
    out = []
    for j in range(0, n, batch_size):
        v, _ = gen.sample_videos(min(batch_size, n - j),
                                 generator=step_generator(SEED, FAKES + j, 0,
                                                          device))
        out.append(v)
    return torch.cat(out)


def random_frames(videos):
    """One uniformly random frame of each clip (the reference's image path)."""
    ix = step_rng(SEED, FRAMES, 0).integers(0, videos.shape[1], len(videos))
    return videos[torch.arange(len(videos)), torch.as_tensor(ix)]


def asset_paths(config, assets_dir: str, labels, frame_size: int):
    """-> (classifier path, embedder path, n_classes) under the JAX
    package's naming."""
    assets = os.path.join(assets_dir, config.dataset)
    # rotmnist pins the 10 digits, so digit-filtered configs share the assets
    n_classes = 10 if config.dataset == "rotmnist" else int(labels.max()) + 1
    # ucf101's classifier width depends on the frame size (Dense after flatten)
    sz = f"_s{frame_size}" if config.dataset == "ucf101" else ""
    return (os.path.join(assets, f"classifier_c{n_classes}{sz}.msgpack"),
            os.path.join(assets, f"embedder_c{n_classes}{sz}.msgpack"),
            n_classes)


def sha256_16(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def feature_model(train, path: str, retrain: bool, data, labels, *,
                  n_classes: int, steps: int, device, what: str):
    """Load the persisted feature model at ``path`` or train and save it:
    -> (model, params, training accuracy or None when loaded)."""
    reuse = os.path.exists(path) and not retrain
    model, params, acc = train(data, labels, n_classes=n_classes,
                               steps=0 if reuse else steps, device=device)
    if reuse:
        print(f"loaded {what} from {path}")
        return model, load_params(path, params), None
    save_params(path, params)
    print(f"trained + saved {what} to {path} (acc {acc:.3f})")
    return model, params, acc


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m ganode_tpu_torch.evaluate")
    p.add_argument("--config", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--data", default=None)
    p.add_argument("--n-samples", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--classifier-steps", type=int, default=300)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--assets-dir", default="eval_assets",
                   help="where the once-trained classifier/embedder params "
                        "live; reused across runs so IS/FVD are comparable")
    p.add_argument("--retrain-assets", action="store_true",
                   help="retrain and overwrite the persisted feature models")
    p.add_argument("--set", dest="sets", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="config overrides; the restore template must match "
                        "the checkpointed model's sizes")
    args = p.parse_args(argv)

    overrides = {"data_path": args.data} if args.data else {}
    try:
        overrides.update(overrides_from_strings(args.sets))
    except ValueError as e:
        p.error(f"--set {e}")
    config = get_config(args.config, **overrides)
    try:
        device = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        sys.exit(f"error: {e}")

    trainer = build_trainer(config, device=device)
    state = trainer.init_state()
    mgr = CheckpointManager(os.path.join(args.workdir, "checkpoints"))
    step = mgr.latest_step()
    if step is not None:
        state = mgr.restore(state)
        print(f"restored checkpoint at step {step}")
    else:
        print("WARNING: no checkpoint found — evaluating the INITIAL generator")

    n = args.n_samples
    real_vids, real_frames, real_labels = real_data(config, n,
                                                    synthetic=args.synthetic)
    fakes = fake_videos(trainer.gen, trainer.eval_gen_variables(state), n,
                        args.batch_size, device)

    cls_path, emb_path, n_classes = asset_paths(
        config, args.assets_dir, real_labels, real_frames.shape[1])
    common = dict(n_classes=n_classes, steps=args.classifier_steps,
                  device=device)
    classifier, cls_params, acc = feature_model(
        train_classifier, cls_path, args.retrain_assets, real_frames,
        real_labels, what="classifier", **common)
    probs = torch.softmax(apply(classifier, cls_params, random_frames(fakes)),
                          dim=-1)
    is_mean, is_std = inception_score(probs)

    embedder, emb_params, emb_acc = feature_model(
        train_video_embedder, emb_path, args.retrain_assets, real_vids,
        real_labels, what="embedder", **common)
    fvd_value = fvd(embed_videos(embedder, emb_params, real_vids,
                                 args.batch_size),
                    embed_videos(embedder, emb_params, fakes,
                                 args.batch_size))

    result = {
        "config": config.name,
        "checkpoint_step": step,
        "n_samples": n,
        "n_fake_videos": int(len(fakes)),
        "frame_sampling": "uniform_random_per_video",
        "asset_hashes": {os.path.basename(q): sha256_16(q)
                         for q in (cls_path, emb_path)},
        "classifier_train_acc": None if acc is None else round(acc, 4),
        "embedder_train_acc": None if emb_acc is None else round(emb_acc, 4),
        "inception_score_mean": round(is_mean, 4),
        "inception_score_std": round(is_std, 4),
        "fvd": round(fvd_value, 4),
    }
    with open(os.path.join(args.workdir, "eval.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
