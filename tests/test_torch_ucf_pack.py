"""The port's offline UCF101 pack (``data/ucf101.py::pack_ucf101``,
``parse_class_index``, ``parse_split``), its synthetic corpus
(``data/synthetic.py``) and the two pack commands, against the JAX
package's on the same files, on the CPU.

Both packages decode with the same OpenCV calls, so the same ``.avi`` files
(MJPG, written with ``cv2`` in the test) must give byte-equal packs:
``frames.u8``, every array of ``index.npz`` and ``meta.json``, with and
without fps resampling. ``write_corpus`` draws with ``RandomState(seed)`` in
the same order, so both packages write byte-equal corpora. The rest are the
twins of ``tests/test_data.py``'s ``TestUCF101Pack`` and
``TestSyntheticCorpus`` cases on the port.
"""
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ganode_tpu.data import synthetic as jax_synthetic
from ganode_tpu.data import ucf101 as jax_ucf101
from ganode_tpu_torch.data import (PackedVideoDataset, UCF101ClipSampler,
                                   UCF101ImageSampler, pack_arrays, prefetch)
from ganode_tpu_torch.data import synthetic, ucf101

cv2 = pytest.importorskip("cv2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_avi(path, frames, rng, fps=25, size=(320, 240)):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, size)
    for _ in range(frames):
        w.write(rng.randint(0, 255, (size[1], size[0], 3), dtype=np.uint8))
    w.release()


@pytest.fixture()
def ucf_tree(tmp_path):
    root = tmp_path / "ucf"
    (root / "videos" / "Clap").mkdir(parents=True)
    (root / "videos" / "Jump").mkdir(parents=True)
    (root / "annotations").mkdir()
    rng = np.random.RandomState(0)
    _write_avi(root / "videos" / "Clap" / "v1.avi", 30, rng)
    _write_avi(root / "videos" / "Clap" / "v2.avi", 8, rng)   # too short
    _write_avi(root / "videos" / "Jump" / "v3.avi", 25, rng)
    _write_avi(root / "videos" / "Jump" / "v4.avi", 40, rng, fps=50)
    (root / "annotations" / "classInd.txt").write_text(
        "1 Clap\n2 Jump\nbad line here\n")
    (root / "annotations" / "trainlist01.txt").write_text(
        "Clap/v1.avi 1\nClap/v2.avi 1\nJump/v3.avi 2\nJump/v4.avi 2\n"
        "Jump/absent.avi 2\nRun/v9.avi 3\n\n")
    (root / "annotations" / "testlist01.txt").write_text("Jump/v3.avi\n")
    return str(root)


def assert_same_pack(a, b):
    assert filecmp.cmp(os.path.join(a, "frames.u8"),
                       os.path.join(b, "frames.u8"), shallow=False)
    ia, ib = np.load(os.path.join(a, "index.npz")), np.load(
        os.path.join(b, "index.npz"))
    assert sorted(ia.files) == sorted(ib.files) == ["labels", "lengths",
                                                   "offsets"]
    for k in ia.files:
        assert ia[k].dtype == ib[k].dtype
        np.testing.assert_array_equal(ia[k], ib[k])
    with open(os.path.join(a, "meta.json")) as fa, open(
            os.path.join(b, "meta.json")) as fb:
        assert json.load(fa) == json.load(fb)


@pytest.mark.parametrize("kw", [
    {}, {"target_fps": 25.0}, {"image_size": 128, "n_frame": 20},
    {"train": False}, {"max_videos": 2}])
def test_pack_ucf101_writes_the_jax_packages_pack(ucf_tree, tmp_path, kw):
    port = ucf101.pack_ucf101(ucf_tree, str(tmp_path / "port"),
                              progress=False, **kw)
    ref = jax_ucf101.pack_ucf101(ucf_tree, str(tmp_path / "jax"),
                                 progress=False, **kw)
    assert_same_pack(port, ref)
    ds = PackedVideoDataset(port)
    assert ds.frames.shape[1:] == (kw.get("image_size", 64),) * 2 + (3,)


def test_the_pack_keeps_the_reference_semantics(ucf_tree, tmp_path):
    ds = PackedVideoDataset(ucf101.pack_ucf101(
        ucf_tree, str(tmp_path / "p"), progress=False))
    # the 8-frame video, the absent file and the unknown class are left out
    assert ds.meta["paths"] == ["Clap/v1.avi", "Jump/v3.avi", "Jump/v4.avi"]
    assert list(ds.labels) == [1, 2, 2] and list(ds.lengths) == [30, 25, 40]
    assert ds.meta["source_fps"] == [25.0, 25.0, 50.0]
    ds = PackedVideoDataset(ucf101.pack_ucf101(
        ucf_tree, str(tmp_path / "fps"), target_fps=25.0, progress=False))
    assert list(ds.lengths) == [30, 25, 20] and ds.meta["target_fps"] == 25.0


def test_parsers_match_jax(ucf_tree):
    ann = os.path.join(ucf_tree, "annotations")
    assert ucf101.parse_class_index(ann) == jax_ucf101.parse_class_index(ann)
    assert ucf101.parse_class_index(ann) == (["Clap", "Jump"],
                                             {"Clap": 1, "Jump": 2})
    for train in (True, False):
        assert ucf101.parse_split(ann, train, 1) == \
            jax_ucf101.parse_split(ann, train, 1)
    assert ucf101.parse_split(ann, False, 1) == ["Jump/v3.avi"]
    with pytest.raises(ValueError, match="fold"):
        ucf101.parse_split(ann, True, 4)
    with pytest.raises(FileNotFoundError):
        ucf101.parse_split(ann, True, 2)


# ----------------------------------------------------- the synthetic corpus
def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_write_corpus_writes_the_jax_packages_corpus(tmp_path):
    kw = dict(min_frames=18, max_frames=24, seed=1, test_every=4)
    got = synthetic.write_corpus(str(tmp_path / "port"), 16, **kw)
    want = jax_synthetic.write_corpus(str(tmp_path / "jax"), 16, **kw)
    assert got == want
    files = _tree_files(tmp_path / "port")
    assert files == _tree_files(tmp_path / "jax")
    for f in files:
        assert filecmp.cmp(tmp_path / "port" / f, tmp_path / "jax" / f,
                           shallow=False), f
    assert_same_pack(
        ucf101.pack_ucf101(str(tmp_path / "port"), str(tmp_path / "pp"),
                           progress=False),
        jax_ucf101.pack_ucf101(str(tmp_path / "jax"), str(tmp_path / "pj"),
                               progress=False))


def test_write_corpus_layout_and_pack(tmp_path):
    root = str(tmp_path / "corpus")
    train_paths, train_labels = synthetic.write_corpus(
        root, 16, min_frames=18, max_frames=24, seed=1, test_every=4)
    classes, class_to_idx = ucf101.parse_class_index(root + "/annotations")
    assert len(classes) == 64
    # 0-based indices carry the factor label directly (label%8 = color)
    assert class_to_idx[classes[0]] == 0
    assert ucf101.parse_split(root + "/annotations", train=True, fold=1) \
        == train_paths
    held_out = ucf101.parse_split(root + "/annotations", train=False, fold=1)
    assert len(held_out) + len(train_paths) == 16

    out = ucf101.pack_ucf101(root, str(tmp_path / "packed"), progress=False)
    ds = PackedVideoDataset(out)
    assert len(ds) == len(train_paths)
    assert list(ds.labels) == train_labels
    assert 18 <= ds.lengths.min() and ds.lengths.max() <= 24
    # the colour octant survives MJPG encode, decode, bicubic resize, crop
    for i in range(len(ds)):
        frame = (ds.frame(i, 0).astype(np.float32) - 128.0) / 128.0
        mask = frame.max(axis=-1) > -0.5
        assert mask.any()
        med = np.median(frame[mask], axis=0)
        assert int((med > 0.6) @ np.array([4, 2, 1])) == ds.labels[i] % 8

    clips, _ = UCF101ClipSampler(out, batch_size=4, n_frame=16).sample(
        np.random.default_rng(0))
    assert clips.shape == (4, 16, 64, 64, 3)
    assert -1.0 <= clips.min() and clips.max() <= 1.0


def test_moving_square_video_matches_jax_and_its_label():
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    checked = 0
    for _ in range(16):
        video, label = synthetic.moving_square_video(a, 12)
        want, want_label = jax_synthetic.moving_square_video(b, 12)
        np.testing.assert_array_equal(video, want)
        assert label == want_label
        assert synthetic.class_name(label) == jax_synthetic.class_name(label)
        pos = []
        for t in range(2):
            yy, xx = np.nonzero(video[t].max(axis=-1) > 0)
            pos.append((xx.min(), xx.max(), yy.min(), yy.max()))
        x_safe, y_safe = synthetic._X_SAFE, synthetic._Y_SAFE
        if any(x0 <= x_safe[0] or x1 >= x_safe[1] - 1 or y0 <= y_safe[0]
               or y1 >= y_safe[1] - 1 for x0, x1, y0, y1 in pos):
            continue  # clamped: the step does not measure (dx, dy)
        dx, dy = pos[1][0] - pos[0][0], pos[1][2] - pos[0][2]
        assert int(np.round(np.arctan2(dy, dx) / (np.pi / 4))) % 8 \
            == label // 8
        checked += 1
    assert checked >= 4


# ------------------------------------------------------------ the commands
def test_the_pack_commands_take_the_jax_scripts_flags(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO}
    root, packed = str(tmp_path / "c"), str(tmp_path / "cp")
    out = subprocess.run(
        [sys.executable, "-m", "ganode_tpu_torch.make_synthetic_ucf101",
         "--root", root, "--pack-out", packed, "--n-videos", "6",
         "--min-frames", "17", "--max-frames", "20", "--fps", "20",
         "--seed", "2", "--image-size", "32"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "encoded 6 videos" in out.stdout and "packed" in out.stdout
    assert PackedVideoDataset(packed).frames.shape[1:] == (32, 32, 3)
    again = str(tmp_path / "again")
    out = subprocess.run(
        [sys.executable, "-m", "ganode_tpu_torch.pack_ucf101", "--root", root,
         "--out", again, "--video-folder", "videos", "--annotation-folder",
         "annotations", "--fold", "1", "--image-size", "32", "--n-frame",
         "16", "--max-videos", "5", "--target-fps", "20"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"packed to {again}"
    assert_same_pack(again, jax_ucf101.pack_ucf101(
        root, str(tmp_path / "jax"), image_size=32, max_videos=5,
        target_fps=20.0, progress=False))
    out = subprocess.run(
        [sys.executable, "-m", "ganode_tpu_torch.pack_ucf101", "--root", root,
         "--out", again, "--test", "--fold", "1", "--image-size", "32"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr


# --------------------------------------- the pack's reader and samplers
def _fake_pack(tmp_path, lengths=(20, 25, 30, 18), size=64):
    rng = np.random.RandomState(0)
    videos = [rng.randint(0, 255, (t, size, size, 3), dtype=np.uint8)
              for t in lengths]
    return pack_arrays(str(tmp_path / "pack"), videos,
                       list(range(len(lengths)))), videos


def test_roundtrip(tmp_path):
    pack_dir, videos = _fake_pack(tmp_path)
    ds = PackedVideoDataset(pack_dir)
    assert len(ds) == 4
    np.testing.assert_array_equal(ds.clip(1, 3, 5), videos[1][3:8])
    np.testing.assert_array_equal(ds.frame(2, 10), videos[2][10])


def test_clip_sampler(tmp_path):
    pack_dir, _ = _fake_pack(tmp_path)
    s = UCF101ClipSampler(pack_dir, batch_size=6, n_frame=16)
    clips, labels = s.sample(np.random.default_rng(0))
    assert clips.shape == (6, 16, 64, 64, 3) and clips.dtype == np.float32
    assert clips.min() >= -1.0 and clips.max() <= 1.0
    again, _ = s.sample(np.random.default_rng(0))
    np.testing.assert_array_equal(clips, again)


def test_short_videos_excluded(tmp_path):
    pack_dir, _ = _fake_pack(tmp_path, lengths=(10, 30))
    s = UCF101ClipSampler(pack_dir, batch_size=4, n_frame=16)
    _, labels = s.sample(np.random.default_rng(0))
    assert np.all(labels == 1)


def test_all_too_short_raises(tmp_path):
    pack_dir, _ = _fake_pack(tmp_path, lengths=(4, 8))
    with pytest.raises(ValueError):
        UCF101ClipSampler(pack_dir, batch_size=2, n_frame=16)


def test_image_sampler(tmp_path):
    pack_dir, _ = _fake_pack(tmp_path)
    frames, _ = UCF101ImageSampler(pack_dir, batch_size=5).sample(
        np.random.default_rng(2))
    assert frames.shape == (5, 64, 64, 3)


def test_host_sharding_disjoint(tmp_path):
    pack_dir, _ = _fake_pack(tmp_path, lengths=(20,) * 6)
    s0 = UCF101ClipSampler(pack_dir, batch_size=4, host_id=0, host_count=2)
    s1 = UCF101ClipSampler(pack_dir, batch_size=4, host_id=1, host_count=2)
    assert set(s0.eligible).isdisjoint(set(s1.eligible))
    assert set(s0.eligible) | set(s1.eligible) == set(range(6))


def test_prefetch(tmp_path):
    pack_dir, _ = _fake_pack(tmp_path)
    s = UCF101ClipSampler(pack_dir, batch_size=2, n_frame=16)
    it = prefetch(s.iterate(np.random.default_rng(0)), size=2, device="cpu")
    batches = [next(it) for _ in range(3)]
    it.close()
    ref = s.iterate(np.random.default_rng(0))
    for clips, labels in batches:
        want = next(ref)
        assert clips.shape == (2, 16, 64, 64, 3)
        assert torch.equal(clips, torch.from_numpy(want[0]))
        assert torch.equal(labels, torch.from_numpy(want[1]))
