"""One ``ucf_gres`` training step (``gres64`` trunk) of the port held against
the JAX step on the CPU, in float64 on both sides; ``test_torch_odegres_step.py``
holds the other GRes config. The method and its tolerances are in
``gres_step_parity.py``."""
import pytest

from gres_step_parity import check_round_trip, check_train_step, jax_steps


@pytest.fixture(scope="module")
def jax_run():
    return jax_steps("ucf_gres")


def test_ucf_gres_train_step_matches_jax(jax_run, monkeypatch):
    """Losses, parameters, statistics, every ``u`` and the Adam moments
    after one whole step; the generator's spectral state advanced once per
    train-mode sample (4 per step at d_iters 1)."""
    check_train_step(jax_run, monkeypatch)


def test_ucf_gres_generator_spectral_state_round_trips(jax_run, monkeypatch):
    check_round_trip(jax_run, monkeypatch)
