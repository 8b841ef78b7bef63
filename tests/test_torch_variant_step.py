"""One whole ``train_step`` of the SDE and CDE variants, the port's
``GANTrainer`` against the JAX one on the CPU, as ``test_torch_train_step``
holds the ODE variant.

A tiny trainer per variant (``mnist28`` trunk, ngf = ndf = 8, B = 2, T = 6,
``PatchImageDiscriminator`` and ``VideoDiscriminator(ksize=2)``, d_iters 2;
the SDE at dt 2.5e-2, 8 substeps per interval; the CDE's field 128 wide) is
built on both sides. The JAX side takes one step from its init, and that
state is carried across (``bridge.gan_state_to_torch``). From there each
side takes one whole step; the noise the JAX step drew (``x0`` and the
Brownian key turned into ``dW`` for the SDE, the path noise for the CDE, and
``z_content`` and ``frame_idx``) is recorded by ``torch_parity.
record_noise`` and fed to the port as its noise tape.

Tolerances, as ``test_torch_train_step``: losses rtol 1e-5; parameters,
BatchNorm running statistics and Adam moments rtol 1e-4 with an absolute
floor of 1e-5 (1e-4 for the second moments) times the leaf's largest
magnitude. Both sides run float32 (JAX with x64 off).
"""
import jax
import numpy as np
import pytest
import torch

from ganode_tpu.models import PatchImageDiscriminator as JaxPatchImage
from ganode_tpu.models import VideoDiscriminator as JaxVideoD
from ganode_tpu.models import make_generator as jax_make_generator
from ganode_tpu.train import GANTrainer as JaxTrainer
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import (PatchImageDiscriminator,
                                     VideoDiscriminator, make_generator)
from ganode_tpu_torch.train import GANTrainer
from torch_parity import (assert_close_tree, np_tree, record_noise, to_torch,
                          uniform)

B, T, NGF, NDF, DZC, DZM = 2, 6, 8, 8, 10, 4
LOSS_RTOL = 1e-5
RTOL, FLOOR, FLOOR_NU = 1e-4, 1e-5, 1e-4
VARIANTS = ["sde", "cde"]


def _generator_kwargs():
    return dict(n_channels=1, trunk="mnist28", video_length=T,
                dim_z_content=DZC, dim_z_motion=DZM, ngf=NGF)


def _batches(seed):
    rng = np.random.default_rng(seed)
    return uniform(rng, 2, B, 28, 28, 1), uniform(rng, 2, B, T, 28, 28, 1)


@pytest.fixture(scope="module", params=VARIANTS)
def jax_run(request):
    """The JAX side of one variant, computed once: the carried-across state
    (after one step), then from it a whole step with the noise it drew."""
    variant = request.param
    tr = JaxTrainer(gen=jax_make_generator(variant, **_generator_kwargs()),
                    dis_img=JaxPatchImage(ndf=NDF),
                    dis_vid=JaxVideoD(ksize=2, ndf=NDF), batch_size=B,
                    d_iters=2)
    with jax.enable_x64(False):
        state0 = jax.jit(tr.init_state)(jax.random.PRNGKey(0))
        images, videos = _batches(1)
        state1, _ = jax.jit(tr.train_step)(state0, images, videos,
                                           jax.random.PRNGKey(1))
        state1 = jax.block_until_ready(state1)
    images, videos = _batches(2)
    (state2, metrics), rec = record_noise(
        jax.jit(lambda *a: tr.train_step(*a)), state1, images, videos,
        jax.random.PRNGKey(2))
    return {"variant": variant, "state1": np_tree(state1),
            "batches": (images, videos),
            "step": (np_tree(state2), np_tree(metrics),
                     rec.samples(B, T, DZC))}


def _port_from(variant, state1):
    gen = make_generator(variant, device="cpu", **_generator_kwargs())
    tr = GANTrainer(gen=gen,
                    dis_img=PatchImageDiscriminator(n_channels=1, ndf=NDF),
                    dis_vid=VideoDiscriminator(n_channels=1, ndf=NDF, ksize=2),
                    batch_size=B, d_iters=2)
    state = tr.init_state()
    bridge.gan_state_to_torch(state1, state)
    return tr, state


def _net_dict(net):
    adam = bridge._adam_state(net.opt_state)
    return {"params": net.params, "batch_stats": net.batch_stats,
            "opt_state": {"count": adam.count, "mu": adam.mu, "nu": adam.nu}}


def test_the_noise_tape_holds_the_variants_noise(jax_run):
    _, _, noise = jax_run["step"]
    assert len(noise) == 6
    assert ["frame_idx" in d for d in noise] == [True, False] * 2 + [False, True]
    motion = {"sde": {"x0": (B, DZM), "dW": (8 * (T - 1), B, DZM)},
              "cde": {"noise": (B, T)}}[jax_run["variant"]]
    for d in noise:
        assert {k: d[k].shape for k in motion} == motion
        assert d["z_content"].shape == (B, DZC)


def test_whole_train_step_matches_jax(jax_run):
    want_state, want_metrics, noise = jax_run["step"]
    images, videos = jax_run["batches"]
    tr, state = _port_from(jax_run["variant"], jax_run["state1"])
    metrics = tr.train_step(state, torch.from_numpy(images),
                            torch.from_numpy(videos), noise=to_torch(noise))
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    got = bridge.torch_gan_state_to_jax(state)
    assert got["step"] == int(want_state.step) == 2
    for name in bridge.NETS:
        want = _net_dict(getattr(want_state, name))
        for part in ("params", "batch_stats"):
            assert_close_tree(got[name][part], want[part], RTOL, FLOOR,
                              f"{name}/{part}")
        assert int(got[name]["opt_state"]["count"]) == int(
            want["opt_state"]["count"])
        assert_close_tree(got[name]["opt_state"]["mu"],
                          want["opt_state"]["mu"], RTOL, FLOOR, f"{name}/mu")
        assert_close_tree(got[name]["opt_state"]["nu"],
                          want["opt_state"]["nu"], RTOL, FLOOR_NU, f"{name}/nu")


def test_state_round_trips_through_the_bridge(jax_run):
    s1 = jax_run["state1"]
    _, state = _port_from(jax_run["variant"], s1)
    back = bridge.torch_gan_state_to_jax(state)
    for name in bridge.NETS:
        want = _net_dict(getattr(s1, name))
        for part in ("params", "batch_stats"):
            assert_close_tree(back[name][part], want[part], 0.0, 0.0,
                              f"{name}/{part}")
        for part in ("mu", "nu"):
            assert_close_tree(back[name]["opt_state"][part],
                              want["opt_state"][part], 0.0, 0.0,
                              f"{name}/{part}")
