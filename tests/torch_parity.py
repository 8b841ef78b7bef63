"""Helpers shared by the port's training parity tests (``test_torch_train_*``,
``test_torch_discriminators``, ``test_torch_runner``): numpy trees, seeded
inputs, the noise a JAX training step drew, recorded so the port can be fed
the same, and a bit-for-bit comparison of two port states.

The JAX samplers draw their noise inside from keyed streams. ``record_noise``
intercepts the modules that consume it (``flax.linen.intercept_methods``):
the ``WarmupMLP`` input is the ODE sampler's ``x0``, the ``MotionODE`` output
its trajectory, and the trunk input ``z`` holds ``z_content`` and, for an
image sample, the motion row of the chosen frame. Inside ``jit`` and
``value_and_grad`` those values are tracers, so they are read with ordered
``jax.debug.callback``s, which run in program order.
"""
from __future__ import annotations

import jax
import numpy as np
import torch
from flax import linen as nn

from ganode_tpu.models.mocogan import DCGANTrunk64, DCGANTrunk128, MNISTTrunk28
from ganode_tpu.models.motion import MotionODE
from ganode_tpu.nn.layers import WarmupMLP

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


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def uniform(rng, *shape):
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


class NoiseRecorder:
    """Records, in program order, what each ODE-motion sample consumed."""

    def __init__(self):
        self.log = []

    def _keep(self, tag, value):
        jax.debug.callback(lambda a: self.log.append((tag, np.asarray(a))),
                           value, ordered=True)

    def __call__(self, next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            m = context.module
            if isinstance(m, WarmupMLP):
                self._keep("x0", args[0])
            elif isinstance(m, MotionODE):
                self._keep("traj", out)
            elif isinstance(m, (MNISTTrunk28, DCGANTrunk64, DCGANTrunk128)):
                self._keep("z", args[0])
        return out

    def samples(self, n: int, video_len: int, dim_z_content: int):
        """One noise dict per sample, as the port's samplers take it:
        ``x0`` and ``z_content``, and ``frame_idx`` for an image sample (the
        trajectory row whose motion the trunk decoded)."""
        if len(self.log) % 3:
            raise AssertionError(f"odd log: {[t for t, _ in self.log]}")
        out = []
        for i in range(0, len(self.log), 3):
            (t0, x0), (t1, traj), (t2, z) = self.log[i:i + 3]
            assert (t0, t1, t2) == ("x0", "traj", "z"), (t0, t1, t2)
            z = z.reshape(z.shape[0], -1)
            noise = {"x0": x0.astype(np.float32)}
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
        return out


def record_noise(fn, *args):
    """Run ``fn(*args)`` with float32 JAX (x64 off) and the recorder on ->
    (result, recorder)."""
    rec = NoiseRecorder()
    with nn.intercept_methods(rec), jax.enable_x64(False):
        out = jax.block_until_ready(fn(*args))
    jax.effects_barrier()
    return out, rec


def to_torch(noise, device="cpu"):
    return [{k: torch.from_numpy(v).to(device) for k, v in d.items()}
            for d in noise]


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


def flat_state(state):
    """Every tensor of a state, by name: modules, Adam state, EMA."""
    out = {"step": torch.tensor(state.step)}
    for name in ("gen", "dis_img", "dis_vid"):
        net = getattr(state, name)
        out.update({f"{name}.{k}": v for k, v in net.module.state_dict().items()})
        names = {p: k for k, p in net.module.named_parameters()}
        for p, s in net.opt.state.items():
            out.update({f"{name}.adam.{names[p]}.{k}": v for k, v in s.items()})
    for k, v in (state.ema_params or {}).items():
        out[f"ema.{k}"] = v
    return out


def assert_bitwise(got, want):
    """Two port states hold the same tensors, bit for bit."""
    a, b = flat_state(got), flat_state(want)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].device == b[k].device, k
        assert torch.equal(a[k], b[k]), k
