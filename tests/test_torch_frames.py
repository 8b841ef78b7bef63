"""The port's frame-folder datasets (``data/frames.py``) held against the
JAX package's (``ganode_tpu/data/frames.py``) on the CPU: JPEG and PNG
trees written by the test with PIL, and the normalization constants.

Exact: the sample lists, and each gather on the picks (and start uniforms)
JAX draws from the same key, rebuilt with JAX's calls. These run on the CPU
only: decoding is PIL's work on the host.
"""
import os

import jax
import numpy as np
import pytest
from PIL import Image

from ganode_tpu.data import frames as jax_frames
from ganode_tpu_torch.data import frames


def _frame_tree(root, n_videos=(3, 2), n_frames=(18, 16, 20, 17, 5)):
    rng = np.random.RandomState(0)
    k = 0
    for c, count in enumerate(n_videos):
        for v in range(count):
            vdir = os.path.join(root, f"class{c}", f"v_{c}_{v}")
            os.makedirs(vdir)
            n = n_frames[k]
            k += 1
            for t in range(n):
                Image.fromarray(rng.randint(0, 255, (12, 12, 3), np.uint8)
                                ).save(os.path.join(vdir, f"image_{t + 1:05d}.jpg"))
            if v == 0:
                with open(os.path.join(vdir, "n_frames"), "w") as f:
                    f.write(f"{n}\n")
    return root


def test_normalization_constants():
    assert frames.get_mean() == jax_frames.get_mean()
    assert frames.get_mean(1.0, "kinetics") == jax_frames.get_mean(1.0, "kinetics")
    assert frames.get_std(1.0) == jax_frames.get_std(1.0)
    with pytest.raises(ValueError):
        frames.get_mean(dataset="imagenet")


@pytest.mark.parametrize("image_size", [None, 8])
def test_frame_folder_videos_match_jax(tmp_path, image_size):
    root = _frame_tree(str(tmp_path / "f"))
    got = frames.FrameFolderVideos(root, 3, n_frame=16, image_size=image_size)
    want = jax_frames.FrameFolderVideos(root, 3, n_frame=16,
                                        image_size=image_size)
    assert got.samples == want.samples and len(got.samples) == 4
    assert got.classes == want.classes
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        k_vid, k_start = jax.random.split(key)
        pick = np.asarray(jax.random.randint(k_vid, (3,), 0, len(want.samples)))
        u = np.asarray(jax.random.uniform(k_start, (3,)))
        x, y = got.gather(pick, u)
        wx, wy = want.sample(key)
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
    s = image_size or 12
    assert x.shape == (3, 16, s, s, 3) and x.dtype == np.float32
    with pytest.raises(ValueError, match=">= 32 frames"):
        frames.FrameFolderVideos(root, 2, n_frame=32)


@pytest.mark.parametrize("flat", [False, True])
def test_image_folder_sampler_matches_jax(tmp_path, flat):
    rng = np.random.RandomState(1)
    root = str(tmp_path / "imgs")
    for i in range(6):
        d = root if flat else os.path.join(root, f"c{i % 3}")
        os.makedirs(d, exist_ok=True)
        ext = ".png" if i % 2 else ".jpg"
        Image.fromarray(rng.randint(0, 255, (10, 14, 3), np.uint8)
                        ).save(os.path.join(d, f"im{i}{ext}"))
    got = frames.ImageFolderSampler(root, 4, image_size=8)
    want = jax_frames.ImageFolderSampler(root, 4, image_size=8)
    assert got.paths == want.paths
    np.testing.assert_array_equal(got.labels, want.labels)
    key = jax.random.PRNGKey(3)
    pick = np.asarray(jax.random.randint(key, (4,), 0, len(want.paths)))
    x, y = got.gather(pick)
    wx, wy = want.sample(key)
    np.testing.assert_array_equal(x, wx)
    np.testing.assert_array_equal(y, wy)
    x, _ = got.sample(np.random.default_rng(0))
    assert x.shape == (4, 8, 8, 3) and x.min() >= -1 and x.max() <= 1
    os.makedirs(tmp_path / "empty")
    with pytest.raises(ValueError, match="no images"):
        frames.ImageFolderSampler(str(tmp_path / "empty"), 2)
