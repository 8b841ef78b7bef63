"""The image discriminator's ODE-GAN step over the MoCoGAN triple with the
euler and rk2 steppers, the port against the JAX trainer on the CPU in
float64 (``tests/odegan_parity.py``; the rk4 steps are in
``test_torch_odegan_mocogan.py``). Euler applies the penalty without its lr
factor, rk2 with it; both take it once, at the undisplaced parameters."""
import pytest
import torch

from ganode_tpu_torch import bridge
from ganode_tpu_torch.train import ODEGANTrainer
from odegan_parity import (LR, REG, assert_params, jax_problem, jax_step,
                           jax_trainer, noise_dict, port_problem)

METHODS = ("euler", "rk2")


@pytest.fixture(scope="module")
def jax_run():
    mods, variables, real = jax_problem()
    params = {n: v["params"] for n, v in variables.items()}
    runs = {m: jax_step(jax_trainer(mods, variables, m), params, 1, real[0],
                        "dis_img") for m in METHODS}
    return variables, params, real[0], runs


@pytest.mark.parametrize("method", METHODS)
def test_an_image_discriminator_step_matches_jax(jax_run, monkeypatch,
                                                 method):
    variables, params, images, runs = jax_run
    want, samples = runs[method]
    mods, losses = port_problem(variables, monkeypatch)
    noise = noise_dict(samples, "dis_img", penalty=True)
    assert sorted(noise, key=str) == sorted([0, "penalty"] + (
        [1] if method == "rk2" else []), key=str)
    before = bridge.odegan_params_to_torch(params, mods)
    got = ODEGANTrainer(*losses, lr=LR, reg=REG, method=method).step(
        before, noise, torch.from_numpy(images), model="dis_img")
    assert_params(got, want)
    assert got["gen"] is before["gen"] and got["dis_vid"] is before["dis_vid"]
