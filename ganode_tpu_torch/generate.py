"""Generate videos with the port (the serving path; twin of
``scripts/generate.py``).

  python -m ganode_tpu_torch.generate --config ucf_ode --num 64 --out v.npz \
      [--workdir RUN | --weights gen.pt] [--gif grid.gif] [--int8] \
      [--set FIELD=VALUE ...] [--video-len 32] [--cpu]

Writes an .npz of videos ``(N, T, H, W, C)`` in [-1, 1] to ``--out`` and an
n x n GIF grid of the first n * n (n = int(sqrt(N))) to ``--gif``; without
either nothing is written. ``--workdir`` serves a training run
(``python -m ganode_tpu_torch.train --workdir RUN``): it builds the config's
trainer, restores the latest checkpoint under ``RUN/checkpoints`` and samples
from ``eval_gen_variables``, the EMA weights when EMA is on; the ``--set``
overrides must give the run's sizes. ``--weights`` loads a bare generator
``state_dict`` instead (for instance one written from JAX variables by
``ganode_tpu_torch.bridge``). With neither, or a workdir without a
checkpoint, the generator runs on its seeded initial weights. Runs on the
CUDA card unless ``--cpu`` is given; with no card and no ``--cpu`` it exits
with an error. ``--int8`` decodes the frames through the int8 serving trunk
(``ops/quant.py``: the served weights quantized once, dynamic activation
scales, K3 on the card): the same latents as the float path, from
``sample_z_video``; a GRes trunk, which has no int8 geometry, exits with an
error.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import resolve_device
from .compat import GeneratorSession
from .models import generator_for_config
from .ops.quant import int8_trunk_apply, quantize_trunk
from .train.runner import build_trainer
from .utils import layout
from .utils.checkpoint import CheckpointManager
from .utils.config import get_config, overrides_from_strings
from .utils.gifs import save_sample_grid

NO_CHECKPOINT = "WARNING: no checkpoint — generating from the initial model"


def _restored(config, workdir, device):
    """-> (the generator, its eval-mode weights) of the latest checkpoint of
    the training run in ``workdir``, or of the trainer's initial state
    (with a warning) when there is none."""
    trainer = build_trainer(config, device=device)
    state = trainer.init_state()
    mgr = CheckpointManager(os.path.join(workdir, "checkpoints"))
    if mgr.latest_step() is not None:
        state = mgr.restore(state)
        print(f"restored step {mgr.latest_step()}")
    else:
        print(NO_CHECKPOINT)
    return trainer.gen, trainer.eval_gen_variables(state)


@torch.no_grad()
def sample_videos_int8(sess: GeneratorSession, trunk: str, qstate: dict,
                       n: int, video_len=None, act_scales=None) -> torch.Tensor:
    """The session's next ``n`` clips with the trunk run in int8: the
    per-frame latents of ``sample_z_video`` (the float path's draws), then
    ``int8_trunk_apply`` on ``qstate`` (``quantize_trunk``), with dynamic
    activation scales or the static ``act_scales`` -> videos ``(n, T, H, W,
    C)`` in [-1, 1]."""
    video_len = video_len or sess.gen.video_length
    z, _ = sess.gen.sample_z_video(n, video_len, generator=sess.generator)
    frames = int8_trunk_apply(trunk, qstate, z, act_scales)  # (n*T, C, H, W)
    return frames.reshape(n, video_len, *frames.shape[1:]).permute(
        0, 1, 3, 4, 2)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m ganode_tpu_torch.generate")
    p.add_argument("--config", required=True)
    p.add_argument("--num", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--video-len", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help=".npz output path")
    p.add_argument("--gif", default=None, help="GIF grid output path")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--workdir", default=None,
                     help="a training run's directory: serve its latest "
                          "checkpoint (the EMA weights when EMA is on)")
    src.add_argument("--weights", default=None,
                     help="port state_dict (.pt) to load into the generator")
    p.add_argument("--set", dest="sets", action="append", default=[],
                   metavar="FIELD=VALUE", help="config overrides")
    p.add_argument("--int8", action="store_true",
                   help="run the trunk through the int8-quantized serving "
                        "path (ops/quant.py, K3 on the card; 4x smaller "
                        "trunk weights)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)

    try:
        overrides = overrides_from_strings(args.sets)
    except ValueError as e:
        p.error(f"--set {e}")
    config = get_config(args.config, **overrides)
    try:
        device = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        sys.exit(f"error: {e}")

    if args.workdir:
        gen, state_dict = _restored(config, args.workdir, device)
    else:
        gen = generator_for_config(config, device=device)
        state_dict = None
        if args.weights:
            state_dict = torch.load(args.weights, map_location="cpu",
                                    weights_only=True)
            print(f"loaded {args.weights}")
        else:
            print(NO_CHECKPOINT)
    sess = GeneratorSession(gen, state_dict, seed=args.seed, device=device)
    if args.int8:
        try:
            qstate = quantize_trunk(config.trunk, sess.gen.main)
        except ValueError as e:
            sys.exit(f"error: {e}")

    videos = []
    for j in range(0, args.num, args.batch_size):
        n = min(args.batch_size, args.num - j)
        if args.int8:
            v = sample_videos_int8(sess, config.trunk, qstate, n,
                                   args.video_len)
        else:
            v, _ = sess.sample_videos(n, args.video_len)
            v = layout.video_from_torch(v)
        videos.append(v.cpu().numpy())
    videos = np.concatenate(videos)
    print(f"generated {videos.shape} in [{videos.min():.3f}, "
          f"{videos.max():.3f}] on {device}")
    if args.out:
        np.savez_compressed(args.out, videos=videos)
        print(f"wrote {args.out}")
    if args.gif:
        n = int(np.sqrt(len(videos)))
        save_sample_grid(args.gif, videos[:n * n], n=n)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
