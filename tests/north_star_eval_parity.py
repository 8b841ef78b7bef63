"""The north-star checkpoint's FVD in both packages, on identical draws, on
the CPU: the port's evaluation against the JAX package's.

    PYTHONPATH=. python tests/north_star_eval_parity.py [--n 256] \
        [--out-json FILE]

Runs ``scripts/diag_raw_vs_ema.py``'s protocol in both packages, in float32
(the run trained with ``compute_dtype=bfloat16``; a compute dtype is not part
of the checkpoint), for the raw and the EMA generator weights of
``ckpt/wgan128_r4/checkpoints/5551``, carried into the port by
``scripts/import_jax_checkpoint.py``:

* reals: ``synthetic_moving_shapes(512, 32, size=128)`` (each package's own
  copy; the two are equal bit for bit), the first ``--n`` embedded;
* fakes: ``--n`` clips in chunks of 64, chunk j from
  ``PRNGKey(10_000 + 5551 + j)``; JAX samples them and its draws (each
  clip's ``x0`` and ``z_content``) are recorded (``torch_parity.
  NoiseRecorder``, one for all calls of the one compiled sampler) and fed
  to the port's sampler;
* features: each package's ``embed_videos`` at batch 32 with the committed
  ``eval_assets/ucf101/embedder_c64_s128.msgpack``, loaded by each
  package's own ``load_params``; FVD by each package's ``fvd``.

Prints per weight set both FVDs, their gap relative to JAX's, the largest
difference between the two packages' clips and features, and the gap to the
figures the JAX package measured on a TPU in bfloat16
(``DEMO_RESULTS_WGAN128_RAWEMA.json``: 859.8905 raw, 927.6631 EMA), which
is reported, not held to a bar: another device and another compute dtype.
Takes ~7 minutes on 8 cores and up to ~15 GB of host memory (JAX's 64-clip decode);
run it alone.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import linen as nn  # noqa: E402

from ganode_tpu.eval import embed_videos as jax_embed  # noqa: E402
from ganode_tpu.eval import fvd as jax_fvd  # noqa: E402
from ganode_tpu.eval import load_params as jax_load  # noqa: E402
from ganode_tpu.eval import train_video_embedder as jax_train_embedder  # noqa: E402
from ganode_tpu.train.runner import build_trainer  # noqa: E402
from ganode_tpu.utils.config import get_config, overrides_from_strings  # noqa: E402
from ganode_tpu_torch.data import synthetic_moving_shapes  # noqa: E402
from ganode_tpu_torch.eval import (embed_videos, fvd, load_params,  # noqa: E402
                                   train_video_embedder)
from torch_parity import NoiseRecorder  # noqa: E402

# torch_parity runs one torch thread per test process; this script runs alone
torch.set_num_threads(os.cpu_count())

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "ckpt", "wgan128_r4", "checkpoints")
EMBEDDER = os.path.join(REPO, "eval_assets", "ucf101",
                        "embedder_c64_s128.msgpack")
SETS = ["batch_size=32", "ema_decay=0.999", "diffaug=color,translation,cutout"]
TPU = {"raw": 859.8905, "ema": 927.6631}   # DEMO_RESULTS_WGAN128_RAWEMA.json
CHUNK, EMB_BS = 64, 32


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--out-json", default=None)
    args = p.parse_args()
    t0 = time.perf_counter()

    state, step, jax_state = _script("import_jax_checkpoint").import_checkpoint(
        "ucf_wgan_gp_128", SETS, CKPT)
    config = get_config("ucf_wgan_gp_128", **overrides_from_strings(SETS))
    trainer = build_trainer(config)
    print(f"imported step {step} ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    videos, labels = synthetic_moving_shapes(512, config.video_length,
                                             size=128)
    jv, jl = _script("demo_tpu_train").synthetic_moving_shapes(
        512, config.video_length, size=128)
    same_reals = bool(np.array_equal(videos, jv) and np.array_equal(labels, jl))
    del jv, jl
    reals = np.ascontiguousarray(videos[:args.n])
    del videos

    jmodel, jparams, _ = jax_train_embedder(reals[:2], labels[:2],
                                            n_classes=64, steps=0)
    jparams = jax_load(EMBEDDER, jparams)
    model, params, _ = train_video_embedder(reals[:2], labels[:2],
                                            n_classes=64, steps=0,
                                            device="cpu")
    params = load_params(EMBEDDER, params)
    real_j = jax_embed(jmodel, jparams, reals, EMB_BS)
    real_t = embed_videos(model, params, reals, EMB_BS)
    real_gap = float(np.abs(real_t.numpy() - real_j).max())
    print(f"reals: equal bit for bit {same_reals}; features max|port - JAX| "
          f"{real_gap:.3e} (of max {np.abs(real_j).max():.3e}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    sample = jax.jit(lambda v, k: trainer.gen.apply(
        v, CHUNK, method="sample_videos", rngs={"sample": k}, train=False)[0])
    # one recorder for every call: the compiled callbacks append to the
    # recorder the sampler was traced with
    rec = NoiseRecorder()

    def jax_sample(variables, key):
        rec.log.clear()
        with nn.intercept_methods(rec), jax.enable_x64(False):
            vids = jax.block_until_ready(sample(variables, key))
            jax.effects_barrier()
        noise = rec.samples(CHUNK, config.video_length, config.dim_z_content)
        assert len(noise) == 1, len(noise)
        return np.asarray(vids), noise[0]

    gen = state.gen.module.eval()
    raw_sd = {k: v.clone() for k, v in gen.state_dict().items()}
    weights = {
        "raw": ({"params": jax_state.gen.params,
                 "batch_stats": jax_state.gen.batch_stats}, raw_sd),
        "ema": (trainer.eval_gen_variables(jax_state),
                {**raw_sd, **state.ema_params}),
    }
    out = {"config": config.name, "step": step, "n": args.n,
           "reals_equal": same_reals, "real_feature_gap": real_gap}
    for tag, (jvars, sd) in weights.items():
        gen.load_state_dict(sd)
        feats_j, feats_t, clip_gap, feat_gap = [], [], 0.0, 0.0
        for j in range(0, args.n, CHUNK):
            vids, noise = jax_sample(jvars,
                                     jax.random.PRNGKey(10_000 + step + j))
            with torch.no_grad():
                got, _ = gen.sample_videos(CHUNK, **{
                    k: torch.from_numpy(np.array(a)) for k, a in noise.items()})
            clip_gap = max(clip_gap, float(np.abs(got.numpy() - vids).max()))
            fj = jax_embed(jmodel, jparams, vids, EMB_BS)
            ft = embed_videos(model, params, got, EMB_BS)
            feat_gap = max(feat_gap, float(np.abs(ft.numpy() - fj).max()))
            feats_j.append(fj)
            feats_t.append(ft)
            print(f"  {tag} chunk {j}: clips max|port - JAX| {clip_gap:.3e}, "
                  f"features {feat_gap:.3e} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        with jax.enable_x64(False):
            f_j = float(jax_fvd(real_j, np.concatenate(feats_j)))
        f_t = fvd(real_t, torch.cat(feats_t))
        out[tag] = {"fvd_jax_cpu": f_j, "fvd_port_cpu": f_t,
                    "rel_gap": abs(f_t - f_j) / abs(f_j),
                    "clip_max_abs_gap": clip_gap,
                    "feature_max_abs_gap": feat_gap,
                    "fvd_tpu_bf16": TPU[tag],
                    "rel_gap_port_to_tpu": abs(f_t - TPU[tag]) / TPU[tag]}
        print(tag, json.dumps(out[tag]), flush=True)
    out["seconds"] = time.perf_counter() - t0
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
