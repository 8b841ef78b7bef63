"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips without a card (decided in the fixture, so
every worker collects the same tests). Run on a machine with a card, without
the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each kernel has two variants: "warp" (one row per group of 16 or 32 lanes,
state in registers; every config's widths) and "wide" (shared-memory tiles;
larger widths). The shapes below take each variant at each lane count, and
``_launch(..., variant="wide")`` forces the wide one at the serving shape.

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


def _variant_counts(module):
    return module.launches, dict(module.launches_by_variant)


@pytest.mark.parametrize("b,d,h,t,variant", [
    (64, 16, 16, 16, "warp"), (5, 10, 24, 6, "warp"), (1, 1, 1, 2, "warp"),
    (1000, 16, 16, 16, "warp"), (63, 16, 16, 16, "warp"),
    (5, 10, 16, 6, "warp"), (7, 20, 32, 5, "warp"), (3, 32, 32, 4, "warp"),
    (33, 64, 200, 9, "wide")])
def test_rk4_kernel_matches_plain(cuda, b, d, h, t, variant):
    args = _rk4(cuda, b, d, h, t)
    total, by_variant = _variant_counts(fused_rk4)
    got = fused_rk4_motion(*args)
    torch.cuda.synchronize()
    assert fused_rk4.launches == total + 1
    by_variant[variant] += 1
    assert fused_rk4.launches_by_variant == by_variant
    torch.testing.assert_close(got, reference_rk4_motion(*args), rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,d,t,variant", [
    (64, 16, 16, "warp"), (5, 10, 6, "warp"), (1, 1, 1, "warp"),
    (1000, 16, 16, "warp"), (63, 16, 16, "warp"), (9, 24, 5, "warp"),
    (4, 32, 3, "warp"), (9, 80, 5, "wide")])
def test_gru_kernel_matches_plain(cuda, b, d, t, variant):
    args = _gru(cuda, b, d, t)
    total, by_variant = _variant_counts(fused_gru)
    got = fused_gru_motion(*args)
    torch.cuda.synchronize()
    assert fused_gru.launches == total + 1
    by_variant[variant] += 1
    assert fused_gru.launches_by_variant == by_variant
    torch.testing.assert_close(got, reference_gru_motion(*args), rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", ["warp", "wide"])
def test_each_variant_at_the_serving_shape(cuda, variant):
    rk4 = _rk4(cuda, 64, 16, 16, 16)
    gru = _gru(cuda, 64, 16, 16)
    with torch.no_grad():
        got_rk4 = fused_rk4._launch(*rk4[:5], 16, fused_rk4.uniform_step(rk4[5]),
                                    variant=variant)
        got_gru = fused_gru._launch(*gru, variant=variant)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_rk4, reference_rk4_motion(*rk4), rtol=0, atol=1e-5)
    torch.testing.assert_close(got_gru, reference_gru_motion(*gru), rtol=0, atol=1e-5)


def test_gradients_through_the_kernels(cuda):
    # The gradient of sum(out ** 2) through the kernel path against the plain
    # version's vector-Jacobian product at the same cotangent, 2 * out of the
    # kernel: the kernel's float32 forward noise (held to 1e-5 above) stays
    # out of the comparison, which is of the backward alone.
    rk4 = _rk4(cuda, 8, 16, 16, 8)
    gru = _gru(cuda, 8, 16, 6)
    for fused, plain, args in ((fused_rk4_motion, reference_rk4_motion, rk4),
                               (fused_gru_motion, reference_gru_motion, gru)):
        leaves = [a.clone().requires_grad_() for a in args[:5]]
        want_leaves = [a.clone().requires_grad_() for a in args[:5]]
        out = fused(*leaves, *args[5:])
        (out ** 2).sum().backward()
        plain(*want_leaves, *args[5:]).backward(2 * out.detach())
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
    # the warp variant refuses widths above its 32 lanes
    with pytest.raises(RuntimeError, match="lane count"):
        fused_rk4._launch(*_rk4(cuda, 2, 33, 16, 3)[:5], 3, 0.5, variant="warp")
