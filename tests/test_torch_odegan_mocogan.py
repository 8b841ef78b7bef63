"""One ODE-GAN rk4 step of each network over the MoCoGAN triple, the port
against the JAX trainer on the CPU in float64 (``tests/odegan_parity.py``
has the problem, the noise and the tolerances): the image discriminator's
step, then the video discriminator's from its result, then the
generator's, as ``tests/test_odegan.py::TestMoCoGANIntegration`` takes
them. Each discriminator step carries the regularizer, a double backward
through the generator's motion and both critics."""
import numpy as np
import pytest
import torch

from ganode_tpu_torch import bridge
from ganode_tpu_torch.train import ODEGANTrainer, module_params
from odegan_parity import (LR, REG, assert_params, changed, jax_problem,
                           jax_step, jax_trainer, noise_dict, port_problem)

STEPS = (("dis_img", 1, 0), ("dis_vid", 2, 1), ("gen", 3, None))


@pytest.fixture(scope="module")
def jax_run():
    mods, variables, real = jax_problem()
    trainer = jax_trainer(mods, variables, "rk4")
    params = {n: v["params"] for n, v in variables.items()}
    runs = []
    for model, seed, batch in STEPS:
        b = None if batch is None else real[batch]
        new, samples = jax_step(trainer, params, seed, b, model)
        runs.append((model, params, b, new, samples))
        params = new
    return variables, runs


@pytest.mark.parametrize("index", [0, 1, 2], ids=[s[0] for s in STEPS])
def test_an_rk4_step_matches_jax(jax_run, monkeypatch, index):
    variables, runs = jax_run
    model, params, batch, want, samples = runs[index]
    mods, losses = port_problem(variables, monkeypatch)
    stats = {n: {k: v.clone() for k, v in m.state_dict().items()}
             for n, m in mods.items()}
    trainer = ODEGANTrainer(*losses, lr=LR, reg=REG, method="rk4")
    before = bridge.odegan_params_to_torch(params, mods)
    noise = noise_dict(samples, model, penalty=model != "gen")
    got = trainer.step(before, noise,
                       None if batch is None else torch.from_numpy(batch),
                       model=model)
    assert_params(got, want)
    # exactly one net moves; the running statistics stay; modes restored
    for n in ("gen", "dis_img", "dis_vid"):
        assert changed(got[n], before[n]) == (n == model), n
    for n, m in mods.items():
        assert m.training
        for k, v in m.state_dict().items():
            assert torch.equal(v, stats[n][k]), (n, k)
    assert all(p.grad is None for m in mods.values() for p in m.parameters())


def test_the_losses_draw_from_a_generator(jax_run, monkeypatch):
    """Without a noise dict every stage draws from the ``torch.Generator``:
    the same seed gives the same step, another seed another; with neither
    the sampler refuses to draw."""
    variables, _ = jax_run
    mods, losses = port_problem(variables, monkeypatch)
    for m in mods.values():   # float32, the dtype the samplers draw in
        m.float()
    trainer = ODEGANTrainer(*losses, lr=LR, reg=REG, method="euler")
    params = {n: module_params(m) for n, m in mods.items()}
    step = lambda seed: trainer.step(
        params, torch.Generator().manual_seed(seed), model="gen")["gen"]
    a, b, c = step(0), step(0), step(1)
    assert not changed(a, b) and changed(a, c)
    assert all(np.isfinite(v.numpy()).all() for v in a.values())
    with pytest.raises(ValueError, match="torch.Generator"):
        trainer.step(params, None, model="gen")
