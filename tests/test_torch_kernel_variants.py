"""What the motion kernels' wrappers decide on the host, pinned on the CPU: the
variant rule (warp kernel at 16 or 32 lanes, else the wide shared-memory
kernel), the CPU path (no launch, the plain version exactly, the JAX
package's reference within float32 noise at each variant's widths), and the
uniform-grid check that lets K1 step by ``ts[1] - ts[0]``.

Tolerances: rtol 1e-5, atol 1e-6 against the JAX reference (float32 sums in
another order), as in tests/test_torch_ops.py; exact against the port's own
plain version.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ganode_tpu import ops as jops
from ganode_tpu_torch.ops import (
    _build,
    fused_gru,
    fused_gru_motion,
    fused_rk4,
    fused_rk4_motion,
    reference_gru_motion,
    reference_rk4_motion,
)
from ganode_tpu_torch.ops.fused_rk4 import uniform_step


@pytest.mark.parametrize("widths,want", [
    ((1,), ("warp", 16)), ((16,), ("warp", 16)), ((17,), ("warp", 32)),
    ((32,), ("warp", 32)), ((33,), ("wide", 0)),
    ((1, 1), ("warp", 16)), ((16, 16), ("warp", 16)),
    ((10, 24), ("warp", 32)), ((16, 17), ("warp", 32)),
    ((17, 16), ("warp", 32)), ((32, 32), ("warp", 32)),
    ((32, 33), ("wide", 0)), ((33, 8), ("wide", 0)), ((64, 200), ("wide", 0))])
def test_variant_rule_at_the_width_boundaries(widths, want):
    assert _build.choose_variant(*widths) == want


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rk4_np(b, d, h, t, seed=0):
    rng = np.random.default_rng(seed)
    return (_normal(rng, b, d), _normal(rng, d, h, scale=1.6 / d ** 0.5),
            _normal(rng, h, scale=0.1), _normal(rng, h, d, scale=1.6 / h ** 0.5),
            _normal(rng, d, scale=0.1), np.linspace(0, 1, t, dtype=np.float32))


def _gru_np(b, d, t, seed=0):
    rng = np.random.default_rng(seed)
    return (_normal(rng, b, d), _normal(rng, t, b, d),
            _normal(rng, d, 3 * d, scale=1.2 / d ** 0.5),
            _normal(rng, d, 3 * d, scale=1.2 / d ** 0.5),
            _normal(rng, 3 * d, scale=0.1), _normal(rng, 3 * d, scale=0.1))


# one shape per variant and lane count: warp at 16 and at 32 lanes, wide
@pytest.mark.parametrize("b,d,h,t", [(3, 16, 16, 5), (3, 16, 17, 5),
                                     (2, 33, 12, 4)])
def test_rk4_cpu_path_at_each_variants_widths(b, d, h, t):
    args = _rk4_np(b, d, h, t)
    before = fused_rk4.launches, dict(fused_rk4.launches_by_variant)
    got = fused_rk4_motion(*(torch.from_numpy(a) for a in args))
    assert (fused_rk4.launches, fused_rk4.launches_by_variant) == before
    torch.testing.assert_close(
        got, reference_rk4_motion(*(torch.from_numpy(a) for a in args)),
        rtol=0, atol=0)
    want = np.asarray(jops.reference_rk4_motion(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,d,t", [(3, 16, 4), (3, 17, 4), (2, 33, 3)])
def test_gru_cpu_path_at_each_variants_widths(b, d, t):
    args = _gru_np(b, d, t)
    before = fused_gru.launches, dict(fused_gru.launches_by_variant)
    got = fused_gru_motion(*(torch.from_numpy(a) for a in args))
    assert (fused_gru.launches, fused_gru.launches_by_variant) == before
    torch.testing.assert_close(
        got, reference_gru_motion(*(torch.from_numpy(a) for a in args)),
        rtol=0, atol=0)
    want = np.asarray(jops.reference_gru_motion(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("make", ["torch", "numpy"])
def test_uniform_step_accepts_float32_linspace(make):
    for t in range(2, 65):
        if make == "torch":
            ts = torch.linspace(0.0, 1.0, t)
        else:
            ts = torch.from_numpy(np.linspace(0, 1, t, dtype=np.float32))
        h = uniform_step(ts)
        # the float32 step, as the kernel takes it
        assert np.float32(h) == ts[1] - ts[0], t


@pytest.mark.parametrize("ts", [[0.0, 0.1, 0.5, 1.0], [0.0, 0.5, 1.0, 1.6],
                                [0.0, 0.25, float("nan"), 0.75]])
def test_uniform_step_refuses_a_non_uniform_grid(ts):
    with pytest.raises(ValueError, match="uniform"):
        uniform_step(torch.tensor(ts))
    x, w1, b1, w2, b2, _ = (torch.from_numpy(a) for a in _rk4_np(2, 4, 4, 4))
    with pytest.raises(ValueError, match="uniform"):
        fused_rk4_motion(x, w1, b1, w2, b2, torch.tensor(ts))


@pytest.mark.parametrize("ts", [torch.zeros(1), torch.zeros(2, 2)])
def test_uniform_step_refuses_a_grid_of_the_wrong_shape(ts):
    with pytest.raises(ValueError, match="1-D"):
        uniform_step(ts)
