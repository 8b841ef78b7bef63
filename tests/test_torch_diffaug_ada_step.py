"""The ADA + R1 step of the port held against JAX's
(``test_torch_diffaug_step.py``'s ``ada_r1`` variant, in a file of its own
so that each file stays under a minute on one worker): ``ada_target=0.6``,
``r1_weight=0.1`` as in the rotated-MNIST ADA runs, d_iters = 2, from a
carried-across state whose ``p`` is 0.5 (image) and 0.3 (video). The
controller's state and the four ADA metrics must be equal, the rest as in
that file.
"""
import pytest

import test_torch_diffaug_step as base


@pytest.fixture(scope="module")
def run():
    kw = base.VARIANTS["ada_r1"]
    return kw, base._jax_run(kw)


def test_the_tape_holds_the_augmentations_draws(run):
    base.check_tape(run)


def test_whole_step_matches_jax(run):
    base.check_step(run)


def test_augmentation_changes_the_step(run):
    base.check_augmentation_matters(run)
