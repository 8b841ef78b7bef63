"""One EMA clip of the imported north-star checkpoint against JAX's.

``scripts/import_jax_checkpoint.py::import_checkpoint`` carries
``ckpt/wgan128_r4/checkpoints/5551`` into the port; both packages then
sample one clip in eval mode from the EMA weights (``sample_videos(1)``:
dopri5 motion, ``dcgan128``, 32 frames of 128x128x3), the port fed the noise
JAX drew for key ``PRNGKey(10_000 + 5551)`` (``torch_parity.NoiseRecorder``).
Both compute in float32 (the run trained with ``compute_dtype=bfloat16``; a
compute dtype is not part of the checkpoint, so both sides are built with
float32 here), JAX under ``enable_x64(False)``; the frames are held at the
conv bar, rtol 1e-4, atol 1e-5.
"""
import importlib.util
import os

import jax
import numpy as np
import torch

from ganode_tpu.train.runner import build_trainer as jax_build_trainer
from ganode_tpu.utils.config import get_config as jax_get_config
from ganode_tpu.utils.config import overrides_from_strings
from torch_parity import record_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "ckpt", "wgan128_r4", "checkpoints")
SETS = ["batch_size=32", "ema_decay=0.999", "diffaug=color,translation,cutout"]
RTOL, ATOL = 1e-4, 1e-5


def test_one_ema_clip_matches_jax():
    spec = importlib.util.spec_from_file_location(
        "import_jax_checkpoint",
        os.path.join(REPO, "scripts", "import_jax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    state, step, jax_state = mod.import_checkpoint("ucf_wgan_gp_128", SETS,
                                                   CKPT)
    config = jax_get_config("ucf_wgan_gp_128", **overrides_from_strings(SETS))
    trainer = jax_build_trainer(config)
    sample = jax.jit(lambda v, k: trainer.gen.apply(
        v, 1, method="sample_videos", rngs={"sample": k}, train=False)[0])
    want, rec = record_noise(sample, trainer.eval_gen_variables(jax_state),
                             jax.random.PRNGKey(10_000 + step))
    noise = rec.samples(1, config.video_length, config.dim_z_content)
    assert len(noise) == 1 and sorted(noise[0]) == ["x0", "z_content"]

    gen = state.gen.module
    gen.load_state_dict({**gen.state_dict(), **state.ema_params})
    gen.eval()
    with torch.no_grad():
        got, _ = gen.sample_videos(1, **{k: torch.from_numpy(np.array(a))
                                         for k, a in noise[0].items()})
    want = np.asarray(want)
    assert got.shape == want.shape == (1, 32, 128, 128, 3)
    # a trained generator: frames far from its initial weights' mid-grey
    assert want.std() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
