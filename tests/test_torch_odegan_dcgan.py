"""The stage-2 experiment's DCGAN pair (``DCGANGen``, ``DCGANDisc``) held against
flax twins of ``scripts/train_odegan.py``'s on the CPU: the forward
passes, and one discriminator and one generator step of each ODE-GAN method
and of the Adam baseline (``tests/odegan_nets_parity.py`` has the twins,
the noise and the tolerances)."""
import pytest

from odegan_nets_parity import METHODS, check_forward, check_step, jax_run

ARCH = "dcgan"


@pytest.fixture(scope="module")
def run():
    return jax_run(ARCH)


def test_the_nets_forward_match_flax(run):
    check_forward(run)


@pytest.mark.parametrize("method", METHODS)
def test_one_step_of_each_net_matches_jax(run, method):
    check_step(run, method)
