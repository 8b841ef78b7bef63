"""The port's serving entry points on the CPU (the ``generate`` CLI and
``GeneratorSession``), its config registry against the JAX package's, and the
rule that the port imports nothing of JAX."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ganode_tpu.utils import config as jax_config
from ganode_tpu.utils import layout as jax_layout
from ganode_tpu_torch.compat import GeneratorSession
from ganode_tpu_torch.models import generator_for_config, make_generator
from ganode_tpu_torch.train import build_trainer
from ganode_tpu_torch.utils import config, layout

REPO = Path(__file__).resolve().parent.parent


def _generate(*args):
    return subprocess.run(
        [sys.executable, "-m", "ganode_tpu_torch.generate", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120)


def test_generate_cli_writes_videos(tmp_path):
    out = tmp_path / "v.npz"
    proc = _generate("--cpu", "--config", "mnist_gru", "--set", "ngf=8",
                     "--num", "4", "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    assert "WARNING: no checkpoint" in proc.stdout
    videos = np.load(out)["videos"]
    assert videos.shape == (4, 16, 28, 28, 1) and videos.dtype == np.float32
    assert np.all(np.isfinite(videos)) and np.abs(videos).max() <= 1.0


def test_generate_cli_loads_weights_and_batches(tmp_path):
    cfg = config.get_config("mnist_ode", ngf=8)
    weights = tmp_path / "gen.pt"
    torch.save(generator_for_config(cfg, device="cpu").state_dict(), weights)
    out = tmp_path / "v.npz"
    proc = _generate("--cpu", "--config", "mnist_ode", "--set", "ngf=8",
                     "--num", "3", "--batch-size", "2", "--video-len", "5",
                     "--weights", str(weights), "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    assert f"loaded {weights}" in proc.stdout
    assert np.load(out)["videos"].shape == (3, 5, 28, 28, 1)


def test_generate_cli_without_a_card_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = _generate("--config", "mnist_gru", "--set", "ngf=8", "--num", "2")
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr and "--cpu" in proc.stderr


def test_generate_cli_rejects_use_pallas():
    proc = _generate("--cpu", "--config", "mnist_gru", "--set", "use_pallas=1")
    assert proc.returncode != 0 and "use_pallas" in proc.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_generator("gru", n_channels=1, trunk="mnist28", ngf=8)
    gen = make_generator("gru", n_channels=1, trunk="mnist28", ngf=8,
                         device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        GeneratorSession(gen)


def test_generator_session_returns_channels_first():
    gen = make_generator("ode", n_channels=1, trunk="mnist28", ngf=8,
                         video_length=6, device="cpu")
    sess = GeneratorSession(gen, seed=0, device="cpu")
    videos, labels = sess.sample_videos(3)
    images, none = sess.sample_images(2)
    assert videos.shape == (3, 1, 6, 28, 28) and labels is None
    assert images.shape == (2, 1, 28, 28) and none is None
    assert not gen.training
    again, _ = sess.sample_videos(3)
    assert not torch.equal(videos, again)  # the session's generator advances
    replay, _ = GeneratorSession(gen, seed=0, device="cpu").sample_videos(3)
    torch.testing.assert_close(videos, replay, rtol=0, atol=0)


def test_config_registry_mirrors_jax():
    assert sorted(config.CONFIGS) == sorted(jax_config.CONFIGS)
    port = {f.name: f.default for f in dataclasses.fields(config.ExperimentConfig)}
    jax_fields = {f.name: f.default
                  for f in dataclasses.fields(jax_config.ExperimentConfig)}
    assert port == {k: v for k, v in jax_fields.items() if k != "use_pallas"}
    for name in config.CONFIGS:
        want = dataclasses.asdict(jax_config.get_config(name))
        del want["use_pallas"]
        assert dataclasses.asdict(config.get_config(name)) == want
    items = ["ngf=8", "betas=0.1,0.2", "motion_method=none", "sde_dt=1e-3",
             "tensorboard=no"]
    want = jax_config.overrides_from_strings(items)
    assert config.overrides_from_strings(items) == want
    with pytest.raises(ValueError, match="use_pallas"):
        config.overrides_from_strings(["use_pallas=1"])


GENERATOR_SIDE = [
    ("mnist_sde", "M10"), ("mnist_cde", "M10"), ("mnist_ode_rnn", "M10"),
    ("mnist_moe_ode", "M10"), ("ucf_gres", "M13"), ("ucf_odegres", "M13"),
    ("ucf_wgan_gp_128", "M9")]
# options of ported configs that the trainer refuses (small widths, so the
# nets build quickly before the refusal)
TRAINER_SIDE = [
    ("mnist_ode", {"image_disc": "sn"}, "M9"),
    ("mnist_ode", {"video_disc": "sn"}, "M9"),
    ("mnist_ode", {"gp_weight": 10.0}, "M9"),
    ("mnist_ode", {"r1_weight": 1.0}, "M9"),
    ("mnist_ode", {"diffaug": "color,translation"}, "M11"),
    ("mnist_gru", {"diffaug": "color", "ada_target": 0.6}, "M11"),
    ("ucf_ode", {"compute_dtype": "bfloat16"}, "M4")]


PORTED = {"M4", "M9", "M10", "M11", "M13"}
FRAME_SIZE = {"mnist28": 28, "dcgan64": 64, "dcgan128": 128, "gres64": 64,
              "odegres64": 64}


def _builds_and_trains(name, overrides):
    """``name`` with ``overrides`` at tiny widths: one CPU training step with
    finite losses, and finite videos of the configured shape."""
    base = config.get_config(name)
    cfg = config.get_config(
        name, ngf=4, ndf=4, batch_size=2, d_iters=1, dim_z_content=4,
        dim_z_motion=4,
        video_length=16 if base.video_disc_ksize == 4 else 8, **overrides)
    tr = build_trainer(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    s, c, t = FRAME_SIZE[cfg.trunk], cfg.n_channels, cfg.video_length
    images = torch.rand((1, 2, s, s, c), generator=g) * 2 - 1
    videos = torch.rand((1, 2, t, s, s, c), generator=g) * 2 - 1
    metrics = tr.train_step(tr.init_state(), images, videos, generator=g)
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    with torch.no_grad():
        out, _ = generator_for_config(cfg, device="cpu").eval().sample_videos(
            2, generator=g)
    assert out.shape == (2, t, s, s, c) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("name,overrides,item", [
    pytest.param(name, {}, item, id=f"{name}-{item}")
    for name, item in GENERATOR_SIDE] + [
    pytest.param(name, over, item, id=f"{name}-{'-'.join(over)}-{item}")
    for name, over, item in TRAINER_SIDE])
def test_unported_configs_name_their_roadmap_item(name, overrides, item):
    """Items still to port raise NotImplementedError naming them; the cases
    of ported items (M4 bf16, M9 WGAN-GP@128, M10 the SDE, CDE, ODE-RNN and
    MoE-ODE motions, M11 DiffAugment and ADA, M13 the GResBlock trunks)
    build at tiny widths on the CPU and take a finite training step
    instead."""
    if item in PORTED:
        _builds_and_trains(name, overrides)
        return
    if overrides:
        cfg = config.get_config(name, ngf=4, ndf=4, **overrides)
    else:
        cfg = config.get_config(name)
        with pytest.raises(NotImplementedError, match=item):
            generator_for_config(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        build_trainer(cfg, device="cpu")


M10_OPTIONS = [
    ("mnist_sde", {"motion_method": m}) for m in
    ("euler", "milstein", "reversible_heun", "reversible_heun_adjoint")] + [
    ("mnist_sde", {"sde_dt": 0.1}), ("mnist_cde", {"motion_method": "midpoint"}),
    ("mnist_ode_rnn", {"motion_method": "heun"}),
    ("mnist_moe_ode", {"motion_method": "dopri5"}),
    ("mnist_moe_ode", {"moe_experts": 3, "moe_top_k": 1})]


@pytest.mark.parametrize("name,overrides", [
    pytest.param(n, o, id=f"{n}-{'-'.join(f'{k}={v}' for k, v in o.items())}")
    for n, o in M10_OPTIONS])
def test_m10_motion_options_build_and_train(name, overrides):
    """The options JAX's runner passes to the new samplers (``motion_method``,
    ``sde_dt``, ``moe_experts``, ``moe_top_k``) reach them, and each builds
    and takes a finite CPU step."""
    _builds_and_trains(name, overrides)
    gen = generator_for_config(config.get_config(name, ngf=4, **overrides),
                               device="cpu")
    m = gen.motion
    assert m.method == overrides.get("motion_method", m.method)
    if "sde_dt" in overrides:
        assert m.dt == overrides["sde_dt"]
    if "moe_experts" in overrides:
        assert (m.moe_fn.expert_w1.shape[0], m.top_k) == (3, 1)


def test_moe_backsolve_trains_on_the_cpu():
    """The MoE sampler's ``adjoint="backsolve"`` (an option of the sampler,
    not of the config, as in JAX) through a whole CPU step."""
    cfg = config.get_config("mnist_moe_ode", ngf=4, ndf=4, batch_size=2,
                            d_iters=1, dim_z_content=4, dim_z_motion=4,
                            video_length=8)
    tr = build_trainer(cfg, device="cpu")
    tr.gen = make_generator("moe_ode", n_channels=1, trunk="mnist28", ngf=4,
                            dim_z_content=4, dim_z_motion=4, video_length=8,
                            adjoint="backsolve", device="cpu")
    g = torch.Generator().manual_seed(0)
    metrics = tr.train_step(tr.init_state(), torch.rand((1, 2, 28, 28, 1),
                                                        generator=g),
                            torch.rand((1, 2, 8, 28, 28, 1), generator=g),
                            generator=g)
    assert tr.gen.motion.adjoint == "backsolve"
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics


@pytest.mark.parametrize("name", ["mnist_sde", "mnist_cde", "mnist_ode_rnn",
                                  "mnist_moe_ode"])
def test_m10_configs_serve_through_the_cli_and_need_the_card(name, tmp_path):
    out = tmp_path / "v.npz"
    proc = _generate("--cpu", "--config", name, "--set", "ngf=8", "--num",
                     "2", "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    videos = np.load(out)["videos"]
    assert videos.shape == (2, 16, 28, 28, 1) and np.all(np.isfinite(videos))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            generator_for_config(config.get_config(name))
        with pytest.raises(RuntimeError, match="no CUDA card"):
            build_trainer(config.get_config(name))


@pytest.mark.parametrize("name", ["video_to_torch", "video_from_torch",
                                  "video_from_tchw", "image_to_torch",
                                  "image_from_torch"])
def test_layout_converters_match_jax(name):
    x = np.random.default_rng(0).standard_normal(
        (2, 3, 4, 5, 6) if "video" in name else (2, 3, 4, 5)).astype(np.float32)
    got = getattr(layout, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(getattr(jax_layout, name)(x)))


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ganode_tpu"}


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "ganode_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert {f: b for f, b in bad.items() if b} == {}
