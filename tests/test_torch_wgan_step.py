"""One ``ucf_wgan_gp_128`` training step of the port held against the JAX
step on the CPU, at tiny widths.

The trainer is ``ucf_wgan_gp_128``'s (``dcgan128`` trunk, dopri5 motion with
its continuous adjoint, ``SNImageDiscriminator``, ``SNVideoDiscriminator(
ksize=4)``, Wasserstein loss, gradient penalty 10) at ngf = ndf = 4, B = 2,
T = 16, d_iters = 1. The JAX side takes one step from its init, so the Adam
moments are non-zero and every ``u`` has moved, and that state is carried
across (``bridge.gan_state_to_torch``, the ``spectral`` collection
included). From there each side takes one whole ``train_step``: the noise
the JAX step drew (``torch_parity.record_noise``) and the interpolation
weights its gradient penalties drew are fed to the port as its noise tape.
The same again with ``fused_real_fake``.

Tolerances: losses rtol 1e-4 (a gradient penalty sums a double backward);
the critics' parameters and every ``u`` rtol 1e-4 with an absolute floor of
1e-5 times the leaf's largest magnitude, as in ``test_torch_train_step.py``
(measured: 2.3e-7 at worst); the critics' Adam moments the same with a floor
of 5e-5 (1e-4 for the second moments, squares of gradients), since their
gradients run through the penalty's double backward (measured: 1.3e-5).

The generator is held looser, for three measured reasons. Its gradients
with respect to the trunk's BatchNorm parameters are sums that cancel (each
BatchNorm's backward removes the per-channel mean of the gradient it passes
on), so their float32 rounding differs between the frameworks by up to
~1e-3 of the leaf's size (9.4e-4 on the first BatchNorm's bias; 3.1e-4 with
rk4 motion in the same trainer, whose motion differs from JAX's by 1e-7: the
trunk, not the solver). Its motion parameters' gradients come from the
adaptive adjoint, accurate to the reverse solve's tolerance (atol 1e-6 on an
adjoint state of that order), and the two solvers choose their own steps
(up to 4.4e-3 of the leaf's size, with ``fused_real_fake``). And Adam,
from a state one step old, divides each gradient by the root of its own two
squares, so an element whose gradients are both near rounding level moves
by about ``lr`` in a direction the rounding picks (up to 9.6 % of a step on
single elements, 0.1 % on average over a leaf). So the generator's Adam
moments are held to rtol 1e-4 plus G_MOMENT_FLOOR = 1.5e-2 of the leaf's
largest magnitude, and its parameters to rtol 1e-4 plus G_PARAM_ATOL = a
quarter of one Adam step (``lr``) per element and G_PARAM_MEAN = 0.5 % of a
step on a leaf's mean.

Both sides run float64, as ``tests/gres_step_parity.py`` does: JAX under
x64 from its float32 init cast up (its trainer still draws the noise in
float32), the port with its nets in float64. In float32 the dopri5 motion's
controller accepts or rejects each step on an error norm near 1, and the
two frameworks' float32 roundings of that norm can fall on either side of
1 on some hosts, which changes every later step of that solve; in float64
they agree to ~1e-16. The JAX generator is built with ``dtype=float64``
so that its trunk computes in float64 too (flax's ``dtype`` is float32
by default, under x64 as well). The bars above, and the figures quoted
for them, come from the float32 comparison; they stay as they were.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import ganode_tpu.train.gan as jax_gan
from ganode_tpu.models import SNImageDiscriminator as JaxSNImage
from ganode_tpu.models import SNVideoDiscriminator as JaxSNVideo
from ganode_tpu.models import make_generator as jax_make_generator
from ganode_tpu.train import GANTrainer as JaxTrainer
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models import (SNImageDiscriminator,
                                     SNVideoDiscriminator, make_generator)
from ganode_tpu_torch.train import GANTrainer
from ganode_tpu_torch.utils.checkpoint import CheckpointManager
from ganode_tpu_torch.utils.config import get_config
from torch_parity import (EpsRecorder, NoiseRecorder, assert_bitwise,
                          assert_close_tree, f64_tree, net_dict, rgb_batches,
                          to_torch)

CFG = get_config("ucf_wgan_gp_128")
B, T, NGF, NDF, DZC, DZM, S = 2, 16, 4, 4, 10, 4, 128
LOSS_RTOL = 1e-4
RTOL, FLOOR, FLOOR_MU, FLOOR_NU = 1e-4, 1e-5, 5e-5, 1e-4
G_PARAM_ATOL, G_PARAM_MEAN, G_MOMENT_FLOOR = 0.25 * CFG.lr, 5e-3 * CFG.lr, 1.5e-2
COMMON = dict(batch_size=B, d_iters=1, loss=CFG.loss, gp_weight=CFG.gp_weight)


def _jax_trainer(fused):
    # the trunk computes in float64 too (its flax dtype), as the port's
    gen = jax_make_generator("ode", n_channels=3, trunk=CFG.trunk,
                             video_length=T, dim_z_content=DZC,
                             dim_z_motion=DZM, ngf=NGF,
                             method=CFG.motion_method, dtype=jnp.float64)
    return JaxTrainer(gen=gen, dis_img=JaxSNImage(ndf=NDF),
                      dis_vid=JaxSNVideo(ksize=CFG.video_disc_ksize, ndf=NDF),
                      fused_real_fake=fused, **COMMON)


def _port_trainer(fused):
    gen = make_generator("ode", n_channels=3, trunk=CFG.trunk, video_length=T,
                         dim_z_content=DZC, dim_z_motion=DZM, ngf=NGF,
                         method=CFG.motion_method, device="cpu")
    tr = GANTrainer(gen=gen,
                    dis_img=SNImageDiscriminator(n_channels=3, ndf=NDF),
                    dis_vid=SNVideoDiscriminator(
                        n_channels=3, ndf=NDF, ksize=CFG.video_disc_ksize),
                    fused_real_fake=fused, **COMMON)
    return tr, tr.init_state()


def _recorded_steps(tr, state0, batches):
    """Two float64 JAX steps (x64) through one compiled function with the
    recorders on: the first makes the carried-across state, the second is
    the step under test -> (state1, state2, metrics2, its noise tape)."""
    eps, rec = EpsRecorder(), NoiseRecorder()
    step = jax.jit(tr.train_step)
    with mock.patch.object(jax_gan, "gradient_penalty", eps), \
            nn.intercept_methods(rec), jax.enable_x64(True):
        state1, _ = jax.block_until_ready(
            step(state0, *batches[0], jax.random.PRNGKey(1)))
        jax.effects_barrier()
        eps.log.clear()
        rec.log.clear()
        state2, metrics = jax.block_until_ready(
            step(state1, *batches[1], jax.random.PRNGKey(2)))
        jax.effects_barrier()
    noise = rec.samples(B, T, DZC)
    assert len(noise) == 4 and len(eps.log) == 2
    for d, e in zip(noise[:2], eps.log):
        d["gp_eps"] = e
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return as_np(state1), as_np(state2), as_np(metrics), noise


@pytest.fixture(scope="module")
def jax_run():
    batches = [f64_tree(rgb_batches(1, B, T, S)),
               f64_tree(rgb_batches(2, B, T, S))]
    out = {"batches": batches[1]}
    tr = _jax_trainer(False)
    with jax.enable_x64(False):
        state0 = f64_tree(jax.jit(tr.init_state)(jax.random.PRNGKey(0)))
    out["plain"] = _recorded_steps(tr, state0, batches)
    # the fused trainer has the same nets: it starts from the same state
    out["fused"] = _recorded_steps(_jax_trainer(True), state0, batches)
    return out


def _port_from(state1, fused=False):
    """The port's trainer in float64 with the carried-across state."""
    tr, state = _port_trainer(fused)
    for name in bridge.NETS:
        getattr(state, name).module.double()
    bridge.gan_state_to_torch(state1, state)
    return tr, state


def _assert_net(got, want, name):
    if name == "gen":  # the cancelling gradients above
        for path, g in jax.tree_util.tree_leaves_with_path(got["params"]):
            w = dict(jax.tree_util.tree_leaves_with_path(want["params"]))[path]
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=G_PARAM_ATOL,
                                       err_msg=f"gen/{path}")
            assert np.abs(g - w).mean() <= G_PARAM_MEAN, path
        floor = floor_nu = G_MOMENT_FLOOR
    else:
        assert_close_tree(got["params"], want["params"], RTOL, FLOOR,
                          f"{name}/params")
        floor, floor_nu = FLOOR_MU, FLOOR_NU
    assert_close_tree(got["batch_stats"], want["batch_stats"], RTOL, FLOOR,
                      f"{name}/batch_stats")
    assert (got["spectral"] is None) == (want["spectral"] is None), name
    if want["spectral"] is not None:
        assert_close_tree(got["spectral"], want["spectral"], RTOL, FLOOR,
                          f"{name}/spectral")
    assert int(got["opt_state"]["count"]) == int(want["opt_state"]["count"])
    assert_close_tree(got["opt_state"]["mu"], want["opt_state"]["mu"], RTOL,
                      floor, f"{name}/mu")
    assert_close_tree(got["opt_state"]["nu"], want["opt_state"]["nu"], RTOL,
                      floor_nu, f"{name}/nu")


@pytest.mark.parametrize("variant", ["plain", "fused"])
def test_wgan_gp_128_train_step_matches_jax(jax_run, variant):
    state1, want_state, want_metrics, noise = jax_run[variant]
    assert ["gp_eps" in d for d in noise] == [True, True, False, False]
    images, videos = jax_run["batches"]
    tr, state = _port_from(state1, fused=variant == "fused")
    u_before = state.dis_vid.module.SNConv_0.u.clone()
    tape = [{k: v.double() if v.is_floating_point() else v
             for k, v in d.items()} for d in to_torch(noise)]
    metrics = tr.train_step(state, torch.from_numpy(images),
                            torch.from_numpy(videos), noise=tape)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    got = bridge.torch_gan_state_to_jax(state)
    assert got["step"] == int(want_state.step) == 2
    for name in bridge.NETS:
        _assert_net(got[name], net_dict(getattr(want_state, name)), name)
    assert not torch.equal(state.dis_vid.module.SNConv_0.u, u_before)
    assert all(p.grad is None for n in bridge.NETS
               for p in getattr(state, n).module.parameters())


def test_spectral_state_round_trips_through_the_bridge(jax_run):
    s1 = jax_run["plain"][0]
    _, state = _port_from(s1)
    back = bridge.torch_gan_state_to_jax(state)
    for name in bridge.NETS:
        want = net_dict(getattr(s1, name))
        for part in ("params", "batch_stats", "spectral"):
            if want[part] is None:
                assert back[name][part] is None
            else:
                assert_close_tree(back[name][part], want[part], 0.0, 0.0,
                                  f"{name}/{part}")
    assert sorted(back["dis_vid"]["spectral"]) == [f"SNConv_{i}"
                                                   for i in range(5)]
    assert back["gen"]["spectral"] is None


def test_a_checkpoint_brings_back_every_u(jax_run, tmp_path):
    _, state = _port_from(jax_run["plain"][0])
    CheckpointManager(str(tmp_path)).save(state.step, state)
    _, fresh = _port_trainer(False)
    for name in bridge.NETS:   # the float64 state's dtype
        getattr(fresh, name).module.double()
    assert not torch.equal(fresh.dis_img.module.SNConv_0.u,
                           state.dis_img.module.SNConv_0.u)
    CheckpointManager(str(tmp_path)).restore(fresh)
    assert_bitwise(fresh, state)
