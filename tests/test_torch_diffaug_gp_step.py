"""The WGAN-GP + DiffAugment step of the port held against JAX's
(``test_torch_diffaug_step.py``'s ``wgan_gp`` variant, in a file of its own
so that each file stays under a minute on one worker), and the
``leaky_relu`` derivative at 0 that it needs.

A penalty differentiates the critic's input gradient, and augmented inputs
hold exact zeros wherever cutout and translation's zero fill cover a whole
window of the first convolution, whose output there is exactly 0. flax's
``leaky_relu`` (``jnp.where(x >= 0, x, slope * x)``) has derivative 1 there;
torch's ``F.leaky_relu`` has the slope. With torch's, this step's critic
moments were 9e-4 of their size from JAX's; with the port's
``nn.layers.leaky_relu``, which follows flax, 6.5e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import test_torch_diffaug_step as base
from ganode_tpu_torch.nn.layers import leaky_relu


@pytest.fixture(scope="module")
def run():
    kw = base.VARIANTS["wgan_gp"]
    return kw, base._jax_run(kw)


def test_the_tape_holds_the_augmentations_draws(run):
    base.check_tape(run)


def test_whole_step_matches_jax(run):
    base.check_step(run)


def test_augmentation_changes_the_step(run):
    base.check_augmentation_matters(run)


def test_leaky_relu_matches_flax_at_zero_in_both_derivatives():
    x = np.array([-1.5, -0.0, 0.0, 0.7], np.float32)
    w = np.array([0.3, -2.0, 1.1, 0.5], np.float32)

    def jf(v):
        g = jax.grad(lambda u: jnp.sum(nn.leaky_relu(u, 0.2) * w))(v)
        return jnp.sum(g * jnp.asarray(x) * v), g

    with jax.enable_x64(False):
        (_, want_g), want_gg = jax.value_and_grad(jf, has_aux=True)(
            jnp.asarray(x))
        want_y = nn.leaky_relu(jnp.asarray(x), 0.2)
    xt = torch.from_numpy(x).requires_grad_()
    y = leaky_relu(xt, 0.2)
    (g,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xt,
                               create_graph=True)
    (gg,) = torch.autograd.grad((g * torch.from_numpy(x) * xt).sum(), xt)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(g.detach().numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(gg.numpy(), np.asarray(want_gg))
