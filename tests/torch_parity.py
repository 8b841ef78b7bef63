"""Helpers shared by the port's training parity tests (``test_torch_train_*``,
``test_torch_discriminators``, ``test_torch_runner``, ``test_torch_variant_
step``, ``test_torch_motion_variants``): numpy trees, seeded inputs, the
noise a JAX training step drew, recorded so the port can be fed the same,
and a bit-for-bit comparison of two port states.

The JAX samplers draw their noise inside from keyed streams. ``record_noise``
intercepts the modules that consume it (``flax.linen.intercept_methods``):
the ``WarmupMLP`` input is the ODE, MoE and SDE samplers' ``x0``, a motion
sampler's output its trajectory, and the trunk input ``z`` holds
``z_content`` and, for an image sample, the motion row of the chosen frame.
What JAX draws inside a function rather than a module is recorded by
wrapping that function for the test (``NoiseRecorder.patch_solvers``, a
pytest ``MonkeyPatch``; the JAX package is not edited): the SDE solvers'
Brownian key, turned into the increments ``dW`` by ``jax_increments``, and
the CDE path handed to ``hermite_cubic_coefficients``; and
``AugRecorder`` records the key each ``diff_augment`` call of the JAX trainer
received, which ``jax_aug_draws`` turns into the port's draws, and
``EpsRecorder`` a gradient penalty's interpolation weights. Inside ``jit``
and ``value_and_grad`` those values are tracers, so they are read with
ordered ``jax.debug.callback``s, which run in program order.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import ganode_tpu.ode as jax_ode
import ganode_tpu.train.gan as jax_gan
from ganode_tpu.models.mocogan import (DCGANTrunk64, DCGANTrunk128,
                                      GResTrunk64, MNISTTrunk28)
from ganode_tpu.models.motion import (MotionCDE, MotionGRU, MotionMoEODE,
                                      MotionODE, MotionSDE)
from ganode_tpu.nn.layers import WarmupMLP
from ganode_tpu.ode.sde import _draw_dW, _substeps

# One torch thread per test process. The suite runs several pytest-xdist
# workers on the machine's cores; with torch's default of one OpenMP thread
# per core each worker's tiny ops wait on threads that other workers have
# taken. Every worker imports this module when it collects the suite.
torch.set_num_threads(1)


def np_tree(tree):
    """A pytree with every leaf as a float32 numpy array (ints kept)."""
    def leaf(a):
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype.kind == "f" else a
    return jax.tree_util.tree_map(leaf, tree)


# XLA's backend optimisation off: about half the compile time of a JAX
# function that runs once (the same function; float32 results within
# rounding of the optimised build)
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def f64_tree(tree):
    """Every float leaf of a tree as a float64 numpy array (float32 leaves
    cast up exactly), the others as numpy arrays."""
    def leaf(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype.kind == "f" else a
    return jax.tree_util.tree_map(leaf, tree)


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def uniform(rng, *shape):
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def rgb_batches(seed, b, t, s):
    """One D iteration's real images ``(1, b, s, s, 3)`` and videos ``(1, b,
    t, s, s, 3)``, uniform in [-1, 1] from ``seed``."""
    rng = np.random.default_rng(seed)
    return uniform(rng, 1, b, s, s, 3), uniform(rng, 1, b, t, s, s, 3)


def net_dict(net):
    """A flax ``NetState`` in the bridge's nested-dict form, its
    ``spectral`` collection included."""
    from ganode_tpu_torch.bridge import _adam_state
    adam = _adam_state(net.opt_state)
    return {"params": net.params, "batch_stats": net.batch_stats,
            "spectral": net.spectral,
            "opt_state": {"count": adam.count, "mu": adam.mu, "nu": adam.nu}}


@jax.jit
def _increment(key, k, y, sqrt_h):
    return _draw_dW(key, k, y, sqrt_h)


def jax_increments(key, ts, dt, shape) -> np.ndarray:
    """The Brownian increments ``(K, *shape)`` that the JAX SDE solvers
    draw from ``key`` over the grid ``ts`` at max step ``dt``:
    ``ganode_tpu.ode.sde._draw_dW(key, k, y0, sqrt_h)`` for each substep k,
    ``sqrt_h = sqrt(|h|)`` of its interval in float32, as the solver
    computes it (x64 off)."""
    spi = _substeps(ts, dt)
    out = []
    with jax.enable_x64(False):
        t = jnp.asarray(np.asarray(ts), jnp.float32)
        y = jnp.zeros(shape, jnp.float32)
        for i in range(len(ts) - 1):
            sqrt_h = jnp.sqrt(jnp.abs((t[i + 1] - t[i]) / spi))
            for j in range(spi):
                out.append(np.asarray(_increment(key, i * spi + j, y, sqrt_h)))
    return np.stack(out)


MOTIONS = (MotionODE, MotionSDE, MotionCDE, MotionMoEODE, MotionGRU)


class NoiseRecorder:
    """Records, in program order, what each motion sample consumed."""

    def __init__(self):
        self.log = []

    def _keep(self, tag, value, extra=None):
        jax.debug.callback(
            lambda a: self.log.append((tag, np.asarray(a), extra)), value,
            ordered=True)

    def __call__(self, next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            m = context.module
            if isinstance(m, WarmupMLP):
                self._keep("x0", args[0])
            elif isinstance(m, MOTIONS):
                self._keep("traj", out)
            elif isinstance(m, (MNISTTrunk28, DCGANTrunk64, DCGANTrunk128,
                                GResTrunk64)):
                self._keep("z", args[0])
        return out

    def patch_solvers(self, mp: pytest.MonkeyPatch):
        """Wrap the JAX SDE solvers and the CDE's spline builder, as the
        samplers reach them (``ganode_tpu.ode.<name>``), to record the
        Brownian key (with the grid, ``dt`` and the state's shape) and the
        path's noise column."""
        for name in ("sdeint", "sdeint_reversible_adjoint"):
            def sde(drift, diffusion, y0, ts, key, *args, _f=getattr(
                    jax_ode, name), dt=None, **kwargs):
                self._keep("dW", key, (np.asarray(ts), dt, y0.shape))
                return _f(drift, diffusion, y0, ts, key, *args, dt=dt,
                          **kwargs)
            mp.setattr(jax_ode, name, sde)

        def hermite(x, t=None, _f=jax_ode.hermite_cubic_coefficients):
            self._keep("noise", x[..., 1])
            return _f(x, t)
        mp.setattr(jax_ode, "hermite_cubic_coefficients", hermite)

    def patch_gru(self, mp: pytest.MonkeyPatch):
        """Wrap the JAX GRU motion's scan (``ganode_tpu.models.motion.
        _manual_scan``, which the sampler reaches by name) to record its
        ``h0`` and ``e``."""
        import ganode_tpu.models.motion as jax_motion

        orig = jax_motion._manual_scan

        def scan(cell, h0, e):
            self._keep("h0", h0)
            self._keep("e", e)
            return orig(cell, h0, e)
        mp.setattr(jax_motion, "_manual_scan", scan)

    def samples(self, n: int, video_len: int, dim_z_content: int):
        """One noise dict per sample, as the port's samplers take it: the
        motion's noise (``x0``, ``dW``, ``noise``) and ``z_content``, and
        ``frame_idx`` for an image sample (the trajectory row whose motion
        the trunk decoded)."""
        out, noise = [], {}
        log = iter(self.log)
        for tag, value, extra in log:
            if tag != "traj":
                assert tag in ("x0", "dW", "noise", "h0", "e") \
                    and tag not in noise, tag
                noise[tag] = (jax_increments(value, *extra) if tag == "dW"
                              else value if value.dtype == np.float64
                              else value.astype(np.float32))
                continue
            traj = value
            tag, z, _ = next(log)
            assert tag == "z", tag
            z = z.reshape(z.shape[0], -1)
            if z.shape[0] == n * video_len:       # a video: rows clip-major
                noise["z_content"] = z[::video_len, :dim_z_content]
            else:                                  # an image
                assert z.shape[0] == n
                noise["z_content"] = z[:, :dim_z_content]
                zm = z[:, dim_z_content:]
                dist = np.abs(traj - zm[:, None, :]).sum(-1)   # (n, T)
                noise["frame_idx"] = dist.argmin(1)
                assert np.allclose(dist.min(1), 0.0, atol=1e-6)
            out.append({k: np.ascontiguousarray(v) for k, v in noise.items()})
            noise = {}
        assert not noise, sorted(noise)
        return out


def record_noise(fn, *args, x64: bool = False):
    """Run ``fn(*args)`` with float32 JAX (x64 off; float64 with ``x64``)
    and the recorder on, the solvers wrapped -> (result, recorder)."""
    rec = NoiseRecorder()
    with pytest.MonkeyPatch.context() as mp, nn.intercept_methods(rec), \
            jax.enable_x64(x64):
        rec.patch_solvers(mp)
        out = jax.block_until_ready(fn(*args))
        jax.effects_barrier()
    return out, rec


def jax_aug_draws(key, shape, ops, gated: bool) -> dict:
    """The draws JAX's ``diff_augment(x, key, ops, p)`` makes for an ``x`` of
    ``shape``, in the port's form (``ganode_tpu_torch.train.diffaug``):
    op ``i`` from ``fold_in(key, i)``, its gate from ``fold_in(key, 1000 +
    i)``, rebuilt with the ``jax.random`` calls of
    ``ganode_tpu/train/diffaug.py`` (x64 off)."""
    b, h, w = shape[0], shape[-3], shape[-2]
    out = {}
    with jax.enable_x64(False):
        key = jnp.asarray(key)
        for i, name in enumerate(ops):
            k = jax.random.fold_in(key, i)
            if name in ("brightness", "saturation", "contrast"):
                draw = jax.random.uniform(k, (b,))
            else:
                ratio = 0.125 if name == "translation" else 0.5
                mh, mw = max(int(h * ratio), 1), max(int(w * ratio), 1)
                if name == "translation":
                    lo, hi = (-mh, -mw), (mh + 1, mw + 1)
                else:
                    lo = (-(mh // 2), -(mw // 2))
                    hi = (h - mh // 2 + 1, w - mw // 2 + 1)
                kh, kw = jax.random.split(k)
                draw = jnp.stack([jax.random.randint(kh, (b,), lo[0], hi[0]),
                                  jax.random.randint(kw, (b,), lo[1], hi[1])])
            out[f"{i}:{name}"] = np.asarray(draw)
            if gated:
                out[f"{i}:gate"] = np.asarray(jax.random.uniform(
                    jax.random.fold_in(key, 1000 + i), (b,)))
    return out


class AugRecorder:
    """Records, in program order, each call of the JAX trainer's
    ``diff_augment`` (``ganode_tpu.train.gan.diff_augment``, wrapped with a
    pytest ``MonkeyPatch``): its key, with the batch's shape, the ops and
    whether it was gated."""

    def __init__(self):
        self.log = []

    def patch(self, mp: pytest.MonkeyPatch):
        orig = jax_gan.diff_augment

        def recorded(x, key, policy, p=None):
            extra = (x.shape, tuple(policy), p is not None)
            jax.debug.callback(
                lambda k: self.log.append((np.asarray(k), extra)), key,
                ordered=True)
            return orig(x, key, policy, p)
        mp.setattr(jax_gan, "diff_augment", recorded)

    def draws(self):
        """The recorded calls' draws, in order (``jax_aug_draws``)."""
        return [jax_aug_draws(k, *extra) for k, extra in self.log]

    def attach(self, tape, d_iters: int):
        """Add the draws to a step's noise tape (``NoiseRecorder.samples``)
        as the port's trainer takes them: ``aug_real`` and ``aug_fake`` to
        each D iteration's sample, ``aug`` to the G update's video, then
        image."""
        draws = self.draws()
        assert len(draws) == len(tape) + 2 * d_iters, len(draws)
        it = iter(draws)
        for i, d in enumerate(tape):
            if i < 2 * d_iters:
                d["aug_real"], d["aug_fake"] = next(it), next(it)
            else:
                d["aug"] = next(it)
        return tape


class EpsRecorder:
    """Records each gradient penalty's interpolation weights, drawn from the
    penalty's key as ``losses.gradient_penalty`` draws them; it stands in
    for ``ganode_tpu.train.gan.gradient_penalty`` (``mock.patch.object``)."""

    def __init__(self):
        self.log = []
        self.orig = jax_gan.gradient_penalty

    def __call__(self, d_apply, real, fake, key, **kw):
        eps = jax.random.uniform(key, (real.shape[0],) + (1,) * (real.ndim - 1),
                                 dtype=real.dtype)
        jax.debug.callback(lambda a: self.log.append(np.asarray(a)), eps,
                           ordered=True)
        return self.orig(d_apply, real, fake, key, **kw)


def to_torch(noise, device="cpu"):
    """Noise dicts of numpy arrays (the augmentation's draws nested) ->
    tensors on ``device``."""
    def conv(d):
        return {k: conv(v) if isinstance(v, dict)
                else torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in d.items()}
    return [conv(d) for d in noise]


def assert_close_tree(got, want, rtol, atol_frac, path=""):
    """Leafwise ``|got - want| <= atol + rtol |want|`` with ``atol =
    atol_frac * max|want|`` of the leaf: a floor for the elements of a sum
    that cancels to near zero, scaled to the leaf."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_close_tree(got[k], want[k], rtol, atol_frac, f"{path}/{k}")
        return
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    atol = atol_frac * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=path)


def assert_close_part(got, want, rtol, atol_frac, path=""):
    """Leafwise ``|got - want| <= atol + rtol |want|`` with ``atol =
    atol_frac * max|want|`` over the whole tree ``want`` (a part of a net:
    all its params, or all its first moments...): a leaf whose exact value
    is 0 (the gradient, hence the moments, of a conv bias that feeds a
    batch-statistics norm) holds rounding noise at the scale of the net,
    not of its own."""
    leaves = jax.tree_util.tree_leaves_with_path(want)
    scale = max(float(np.abs(np.asarray(a)).max()) for _, a in leaves)
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat) == len(leaves), path
    for p, w in leaves:
        np.testing.assert_allclose(
            np.asarray(flat[p], np.float64), np.asarray(w, np.float64),
            rtol=rtol, atol=atol_frac * scale,
            err_msg=f"{path}{jax.tree_util.keystr(p)}")


def flat_state(state):
    """Every tensor of a state, by name: modules, Adam state, EMA, ADA."""
    out = {"step": torch.tensor(state.step)}
    for name in ("gen", "dis_img", "dis_vid"):
        net = getattr(state, name)
        out.update({f"{name}.{k}": v for k, v in net.module.state_dict().items()})
        names = {p: k for k, p in net.module.named_parameters()}
        for p, s in net.opt.state.items():
            out.update({f"{name}.adam.{names[p]}.{k}": v for k, v in s.items()})
    for k, v in (state.ema_params or {}).items():
        out[f"ema.{k}"] = v
    for k, v in (state.ada or {}).items():
        out[f"ada.{k}"] = v
    return out


def assert_bitwise(got, want):
    """Two port states hold the same tensors, bit for bit."""
    a, b = flat_state(got), flat_state(want)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].device == b[k].device, k
        assert torch.equal(a[k], b[k]), k
