"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips without a card (decided in the fixture, so
every worker collects the same tests). Run on a machine with a card, without
the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Float32 with TF32 off for matrix products. Tolerances: 1e-5 abs on
trajectories; rtol 1e-4 on gradients, whose backward differentiates the plain
version on the card.
"""
import pytest
import torch

from ganode_tpu_torch.ops import (
    fused_gru,
    fused_gru_motion,
    fused_rk4,
    fused_rk4_motion,
    reference_gru_motion,
    reference_rk4_motion,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# Weights scale as 1/sqrt(fan_in), as the model's initialisers have them, so
# the trajectories stay O(1) at every width and 1e-5 abs is a float32 bar.
def _rk4(dev, b, d, h, t, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to(dev)
    return [r(b, d), r(d, h, scale=1.6 / d ** 0.5), r(h, scale=0.1),
            r(h, d, scale=1.6 / h ** 0.5), r(d, scale=0.1),
            torch.linspace(0.0, 1.0, t)]


def _gru(dev, b, d, t, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to(dev)
    return [r(b, d), r(t, b, d), r(d, 3 * d, scale=1.2 / d ** 0.5),
            r(d, 3 * d, scale=1.2 / d ** 0.5), r(3 * d, scale=0.1),
            r(3 * d, scale=0.1)]


@pytest.mark.parametrize("b,d,h,t", [(64, 16, 16, 16), (5, 10, 24, 6),
                                     (1, 1, 1, 2), (1000, 16, 16, 16),
                                     (33, 64, 200, 9)])
def test_rk4_kernel_matches_plain(cuda, b, d, h, t):
    args = _rk4(cuda, b, d, h, t)
    before = fused_rk4.launches
    got = fused_rk4_motion(*args)
    torch.cuda.synchronize()
    assert fused_rk4.launches == before + 1
    torch.testing.assert_close(got, reference_rk4_motion(*args), rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,d,t", [(64, 16, 16), (5, 10, 6), (1, 1, 1),
                                   (1000, 16, 16), (9, 80, 5)])
def test_gru_kernel_matches_plain(cuda, b, d, t):
    args = _gru(cuda, b, d, t)
    before = fused_gru.launches
    got = fused_gru_motion(*args)
    torch.cuda.synchronize()
    assert fused_gru.launches == before + 1
    torch.testing.assert_close(got, reference_gru_motion(*args), rtol=0, atol=1e-5)


def test_gradients_through_the_kernels(cuda):
    rk4 = _rk4(cuda, 8, 16, 16, 8)
    gru = _gru(cuda, 8, 16, 6)
    for fused, plain, args in ((fused_rk4_motion, reference_rk4_motion, rk4),
                               (fused_gru_motion, reference_gru_motion, gru)):
        leaves = [a.clone().requires_grad_() for a in args[:5]]
        want_leaves = [a.clone().requires_grad_() for a in args[:5]]
        (fused(*leaves, *args[5:]) ** 2).sum().backward()
        (plain(*want_leaves, *args[5:]) ** 2).sum().backward()
        for a, b in zip(leaves, want_leaves):
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-6)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x, w1, b1, w2, b2, ts = _rk4(cuda, 4, 16, 16, 4)
    with pytest.raises(ValueError, match="contiguous"):
        fused_rk4_motion(x, w1.t().contiguous().t(), b1, w2, b2, ts)
    with pytest.raises(ValueError):
        fused_rk4_motion(x, w1.cpu(), b1, w2, b2, ts)
    with pytest.raises(ValueError, match="uniform"):
        fused_rk4_motion(x, w1, b1, w2, b2, torch.tensor([0.0, 0.1, 0.5, 1.0]))
    # D = H = 200 needs 2*200*200 floats of weights alone: more shared memory
    # than a block may have, so the launcher refuses before launching
    big = _rk4(cuda, 2, 200, 200, 3)
    with pytest.raises(RuntimeError, match="shared memory"):
        fused_rk4_motion(*big)
    with pytest.raises(RuntimeError, match="shared memory"):
        fused_gru_motion(*_gru(cuda, 2, 120, 2))
