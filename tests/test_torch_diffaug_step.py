"""Whole training steps with DiffAugment and ADA: the port's ``GANTrainer``
held against the JAX ``GANTrainer`` on the CPU.

A tiny trainer (``ode`` motion, ``mnist28`` trunk, ngf = ndf = 4, B = 2,
T = 6, ``PatchImageDiscriminator`` and ``VideoDiscriminator(ksize=2)``)
with the policy ``color,translation,cutout``, in three variants: BCE (the
plain DiffAugment, d_iters = 1), ADA with R1 (``ada_target=0.6``,
``r1_weight=0.1``, the rotated-MNIST runs' settings, d_iters = 2, so the
second D iteration runs on the controller's first update), and WGAN-GP
(Wasserstein, ``gp_weight=10``, d_iters = 1). This file runs the first;
``test_torch_diffaug_ada_step.py`` and ``test_torch_diffaug_gp_step.py`` run
the others with its helpers, so that each file stays under a minute on one
worker. The JAX side takes one step
from its init, so the Adam moments are non-zero, and that state is carried
across (``bridge.gan_state_to_torch``, ``ada`` included). An untrained D's
``rt`` stays below the target, so ``p`` would still be 0 and every gate
closed: the carried state's ``p`` is set to 0.5 and 0.3 on both sides, and
``ada_step=0.1`` moves it visibly. Then each side takes one whole
``train_step``: the noise the JAX samplers drew (``torch_parity.record_noise``'s recorder), the keys its
``diff_augment`` calls received (``torch_parity.AugRecorder``, rebuilt into
draws) and, with the GP, its interpolation weights are fed to the port as
its noise tape.

Tolerances, as in ``test_torch_train_step.py``: losses rtol 1e-5 (1e-4 with
a penalty, whose double backward sums in another order); parameters,
BatchNorm statistics and Adam moments rtol 1e-4 with an absolute floor of
1e-5 (first moments; 5e-5 with a penalty, as ``test_torch_wgan_step.py``
measured) and 1e-4 (second moments) times the leaf's largest magnitude. The
ADA state is exact: ``rt`` is a mean of signs and ``p`` a clipped sum of
``±ada_step``. Both sides run float32 (JAX with x64 off).
"""
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

import ganode_tpu.train.gan as jax_gan
from ganode_tpu.models import PatchImageDiscriminator as JaxPatchImage
from ganode_tpu.models import VideoDiscriminator as JaxVideoD
from ganode_tpu.models import make_generator as jax_make_generator
from ganode_tpu.train import GANTrainer as JaxTrainer
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import (PatchImageDiscriminator,
                                     VideoDiscriminator, make_generator)
from ganode_tpu_torch.train import GANTrainer
from torch_parity import (AugRecorder, EpsRecorder, NoiseRecorder,
                          assert_close_tree, np_tree, to_torch, uniform)

B, T, NGF, NDF, DZC, DZM = 2, 6, 4, 4, 10, 4
POLICY = "color,translation,cutout"
VARIANTS = {
    "diffaug": dict(diffaug=POLICY, d_iters=1),
    "ada_r1": dict(diffaug=POLICY, ada_target=0.6, ada_step=0.1,
                   r1_weight=0.1, d_iters=2),
    "wgan_gp": dict(diffaug=POLICY, loss="wasserstein", gp_weight=10.0,
                    d_iters=1),
}
CARRIED_P = {"p_img": 0.5, "p_vid": 0.3}
RTOL, FLOOR_NU = 1e-4, 1e-4
ADA_METRICS = ("rt_img", "rt_vid", "ada_p_img", "ada_p_vid")


def _penalised(kw):
    return kw.get("gp_weight", 0) > 0 or kw.get("r1_weight", 0) > 0


def _jax_trainer(kw):
    gen = jax_make_generator("ode", n_channels=1, trunk="mnist28",
                             video_length=T, dim_z_content=DZC,
                             dim_z_motion=DZM, ngf=NGF)
    return JaxTrainer(gen=gen, dis_img=JaxPatchImage(ndf=NDF),
                      dis_vid=JaxVideoD(ksize=2, ndf=NDF), batch_size=B,
                      **kw)


def _port_trainer(kw):
    gen = make_generator("ode", n_channels=1, trunk="mnist28", video_length=T,
                         dim_z_content=DZC, dim_z_motion=DZM, ngf=NGF,
                         device="cpu")
    tr = GANTrainer(gen=gen,
                    dis_img=PatchImageDiscriminator(n_channels=1, ndf=NDF),
                    dis_vid=VideoDiscriminator(n_channels=1, ndf=NDF, ksize=2),
                    batch_size=B, **kw)
    return tr, tr.init_state()


def _batches(seed, d_iters):
    rng = np.random.default_rng(seed)
    return (uniform(rng, d_iters, B, 28, 28, 1),
            uniform(rng, d_iters, B, T, 28, 28, 1))


def _jax_run(kw):
    """Two JAX steps through one compiled function with the recorders on:
    the first makes the carried-across state, the second is the step under
    test -> (state1, state2, metrics2, its noise tape)."""
    tr, d = _jax_trainer(kw), kw["d_iters"]
    rec, aug, eps = NoiseRecorder(), AugRecorder(), EpsRecorder()
    with pytest.MonkeyPatch.context() as mp, \
            mock.patch.object(jax_gan, "gradient_penalty", eps), \
            nn.intercept_methods(rec), jax.enable_x64(False):
        aug.patch(mp)
        state0 = jax.jit(tr.init_state)(jax.random.PRNGKey(0))
        step = jax.jit(tr.train_step)
        state1, _ = jax.block_until_ready(
            step(state0, *_batches(1, d), jax.random.PRNGKey(1)))
        jax.effects_barrier()
        if state1.ada is not None:
            state1 = state1.replace(ada={
                k: jax.numpy.asarray(v, jax.numpy.float32)
                for k, v in CARRIED_P.items()})
        for r in (rec, aug, eps):
            r.log.clear()
        state2, metrics = jax.block_until_ready(
            step(state1, *_batches(2, d), jax.random.PRNGKey(2)))
        jax.effects_barrier()
    tape = rec.samples(B, T, DZC)
    if kw.get("diffaug"):
        aug.attach(tape, d)
    if kw.get("gp_weight", 0) > 0:
        assert len(eps.log) == 2 * d
        for noise, e in zip(tape, eps.log):
            noise["gp_eps"] = e
    return np_tree(state1), np_tree(state2), np_tree(metrics), tape


@pytest.fixture(scope="module")
def run():
    kw = VARIANTS["diffaug"]
    return kw, _jax_run(kw)


def _net_dict(net):
    adam = bridge._adam_state(net.opt_state)
    return {"params": net.params, "batch_stats": net.batch_stats,
            "opt_state": {"count": adam.count, "mu": adam.mu, "nu": adam.nu}}


def check_tape(run):
    """JAX's recorded tape and the port's own hold the same draws."""
    kw, (_, _, _, tape) = run
    gated = kw.get("ada_target", 0) > 0
    want = sorted(["0:brightness", "1:saturation", "2:contrast",
                   "3:translation", "4:cutout"]
                  + ([f"{i}:gate" for i in range(5)] if gated else []))
    for i, d in enumerate(tape):
        keys = ("aug_real", "aug_fake") if i < 2 * kw["d_iters"] else ("aug",)
        assert all(sorted(d[k]) == want for k in keys), (i, sorted(d))
    # the port's own tape has the same layout
    tr, _ = _port_trainer(kw)
    port = tr.noise_tape(torch.Generator().manual_seed(0), "cpu")
    assert [sorted(d) for d in port] == [sorted(d) for d in tape]
    for d, ref in zip(port, tape):
        for k in ("aug_real", "aug_fake", "aug"):
            if k in ref:
                assert {n: tuple(v.shape) for n, v in d[k].items()} == {
                    n: v.shape for n, v in ref[k].items()}


def check_step(run):
    """One whole port step from the carried-across state and JAX's tape
    equals JAX's step."""
    kw, (state1, want_state, want_metrics, tape) = run
    tr, state = _port_trainer(kw)
    bridge.gan_state_to_torch(state1, state)
    gated = kw.get("ada_target", 0) > 0
    assert (state.ada is not None) == gated
    images, videos = _batches(2, kw["d_iters"])
    metrics = tr.train_step(state, torch.from_numpy(images),
                            torch.from_numpy(videos), noise=to_torch(tape))
    assert sorted(metrics) == sorted(want_metrics)
    loss_rtol = 1e-4 if _penalised(kw) else 1e-5
    for k, v in want_metrics.items():
        if k in ADA_METRICS:
            assert float(metrics[k]) == float(v), k
        else:
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=loss_rtol, err_msg=k)
    got = bridge.torch_gan_state_to_jax(state)
    if gated:
        for k in ("p_img", "p_vid"):
            assert got["ada"][k] == want_state.ada[k], k
            assert float(got["ada"][k]) == float(metrics[f"ada_p_{k[2:]}"])
        # the controller moved both probabilities in the step
        assert all(float(got["ada"][k]) != CARRIED_P[k] for k in CARRIED_P)
    else:
        assert got["ada"] is None and want_state.ada is None
    floor_mu = 5e-5 if _penalised(kw) else 1e-5
    assert got["step"] == int(want_state.step) == 2
    for name in bridge.NETS:
        want = _net_dict(getattr(want_state, name))
        mine = got[name]
        assert_close_tree(mine["params"], want["params"], RTOL, 1e-5,
                          f"{name}/params")
        assert_close_tree(mine["batch_stats"], want["batch_stats"], RTOL,
                          1e-5, f"{name}/batch_stats")
        assert int(mine["opt_state"]["count"]) == int(want["opt_state"]["count"])
        assert_close_tree(mine["opt_state"]["mu"], want["opt_state"]["mu"],
                          RTOL, floor_mu, f"{name}/mu")
        assert_close_tree(mine["opt_state"]["nu"], want["opt_state"]["nu"],
                          RTOL, FLOOR_NU, f"{name}/nu")


def check_augmentation_matters(run):
    """The same tape without the policy takes another step: the draws are
    not ignored."""
    kw, (state1, want_state, _, tape) = run
    plain = {k: v for k, v in kw.items()
             if k not in ("diffaug", "ada_target", "ada_step")}
    tr, state = _port_trainer(plain)
    bridge.gan_state_to_torch(state1, state)
    state.ada = None
    images, videos = _batches(2, kw["d_iters"])
    strip = [{k: v for k, v in d.items() if not k.startswith("aug")}
             for d in tape]
    tr.train_step(state, torch.from_numpy(images), torch.from_numpy(videos),
                  noise=to_torch(strip))
    got = bridge.torch_gan_state_to_jax(state)["gen"]["params"]
    want = want_state.gen.params
    diffs = [np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want))]
    assert max(diffs) > 1e-5


def test_the_tape_holds_the_augmentations_draws(run):
    check_tape(run)


def test_whole_step_matches_jax(run):
    check_step(run)


def test_augmentation_changes_the_step(run):
    check_augmentation_matters(run)
