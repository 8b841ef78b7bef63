"""The port's clip-consistent transforms (``data/transforms.py``) held
against the JAX package's (``ganode_tpu/data/transforms.py``) on the CPU.

The keyed transforms are fed the draws JAX makes from the same key,
rebuilt here with JAX's own calls (``jax.random.bernoulli``, the key
splits, ``randint``), as ``tests/torch_parity.py`` rebuilds the trainer's
draws. Bars: exact for the crops, flips, padding and temporal windows (they
move values); rtol 1e-5, atol 1e-6 for ``normalize`` and for the bilinear
resizes of the multi-scale crops (float32 filters summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu.data import transforms as jt
from ganode_tpu_torch.data import transforms as tt

SCALES = (1.0, 0.84, 0.71, 0.59, 0.5)
POSITIONS = ("c", "tl", "tr", "bl", "br")


def _clip(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _flip_draw(key, p):
    return bool(jax.random.bernoulli(key, p))


def _crop_draw(key, clip, size):
    ky, kx = jax.random.split(key)
    h, w = clip.shape[-3], clip.shape[-2]
    return (int(jax.random.randint(ky, (), 0, h - size + 1)),
            int(jax.random.randint(kx, (), 0, w - size + 1)))


@pytest.mark.parametrize("seed", range(4))
def test_random_horizontal_flip(seed):
    clip, key = _clip(4, 6, 7, 3), jax.random.PRNGKey(seed)
    want = jt.random_horizontal_flip(key, jnp.asarray(clip), 0.5)
    got = tt.random_horizontal_flip(torch.from_numpy(clip), 0.5,
                                    flip=_flip_draw(key, 0.5))
    _eq(got, want)


def test_deterministic_crops_and_normalize():
    clip = _clip(2, 10, 12, 3)
    x = torch.from_numpy(clip)
    _eq(tt.center_crop(x, 6), jt.center_crop(jnp.asarray(clip), 6))
    for pos in POSITIONS:
        _eq(tt.corner_crop(x, 6, pos), jt.corner_crop(jnp.asarray(clip), 6, pos))
    mean, std = [0.4, 0.5, 0.6], [0.2, 0.25, 0.3]
    _close(tt.normalize(x, mean, std), jt.normalize(jnp.asarray(clip), mean, std))


@pytest.mark.parametrize("seed", range(3))
def test_random_crop(seed):
    clip, key = _clip(4, 20, 18, 1, seed=seed), jax.random.PRNGKey(seed)
    want = jt.random_crop(key, jnp.asarray(clip), 8)
    got = tt.random_crop(torch.from_numpy(clip), 8,
                         offsets=_crop_draw(key, clip, 8))
    _eq(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_multi_scale_corner_crop(seed):
    clip, key = _clip(3, 24, 20, 3, seed=seed), jax.random.PRNGKey(seed)
    want = jt.multi_scale_corner_crop(key, jnp.asarray(clip), 16)
    k_scale, k_pos = jax.random.split(key)
    s = int(jax.random.randint(k_scale, (), 0, len(SCALES)))
    p = int(jax.random.randint(k_pos, (), 0, len(POSITIONS)))
    got = tt.multi_scale_corner_crop(torch.from_numpy(clip), 16,
                                     scale_idx=s, pos_idx=p)
    _close(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_multi_scale_random_crop(seed):
    clip, key = _clip(3, 24, 20, 3, seed=seed), jax.random.PRNGKey(seed)
    want = jt.multi_scale_random_crop(key, jnp.asarray(clip), 12)
    k_scale, k_pos = jax.random.split(key)
    s = int(jax.random.randint(k_scale, (), 0, len(SCALES)))
    crop = int(20 * SCALES[s])
    got = tt.multi_scale_random_crop(torch.from_numpy(clip), 12, scale_idx=s,
                                     offsets=_crop_draw(k_pos, clip, crop))
    _close(got, want)


@pytest.mark.parametrize("t,size", [(3, 8), (10, 4), (8, 8)])
def test_temporal_transforms(t, size):
    clip = _clip(t, 2, 2, 1)
    x, j = torch.from_numpy(clip), jnp.asarray(clip)
    _eq(tt.loop_padding(x, size), jt.loop_padding(j, size))
    _eq(tt.temporal_begin_crop(x, size), jt.temporal_begin_crop(j, size))
    _eq(tt.temporal_center_crop(x, size), jt.temporal_center_crop(j, size))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        start = int(jax.random.randint(key, (), 0, max(0, t - size) + 1))
        _eq(tt.temporal_random_crop(x, size, start=start),
            jt.temporal_random_crop(key, j, size))


def test_per_clip_draws_per_element():
    batch, key = _clip(16, 4, 8, 8, 1), jax.random.PRNGKey(0)
    want = jt.per_clip(lambda k, c: jt.random_horizontal_flip(k, c, 0.5), key,
                       jnp.asarray(batch))
    flips = torch.tensor([_flip_draw(k, 0.5)
                          for k in jax.random.split(key, 16)])
    got = tt.per_clip(tt.random_horizontal_flip, torch.from_numpy(batch),
                      draws={"flip": flips})
    _eq(got, want)
    assert 0 < int(flips.sum()) < 16   # some flip, some don't


def test_drawn_from_a_generator_when_not_given():
    """Without the draws, each keyed transform draws from the
    ``torch.Generator``: the same seed, the same clip."""
    clip = torch.from_numpy(_clip(8, 20, 20, 3))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        x = tt.per_clip(tt.random_horizontal_flip, clip[None].repeat(
            4, 1, 1, 1, 1), generator=g)
        return (x, tt.random_crop(clip, 8, generator=g),
                tt.multi_scale_corner_crop(clip, 16, generator=g),
                tt.multi_scale_random_crop(clip, 16, generator=g),
                tt.temporal_random_crop(clip, 4, generator=g))

    for a, b in zip(run(3), run(3)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="torch.Generator"):
        tt.random_crop(clip, 8)


def test_target_transforms_are_the_reference_ones():
    target = {"label": 7, "video_id": "v_x_g01_c01"}
    for name in ("class_label", "video_id"):
        assert getattr(tt, name)(target) == getattr(jt, name)(target)
    assert tt.compose_targets(tt.class_label, tt.video_id)(target) == [
        7, "v_x_g01_c01"]
