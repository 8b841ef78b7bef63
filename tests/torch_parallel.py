"""Helpers of the port's multi-process tests (``test_torch_parallel_*``,
``test_torch_runner_mesh``): start the ranks of a gloo group on the CPU,
each a ``tests/torch_parallel_worker.py`` process, and collect their
results.

Each run rendezvouses through a ``file://`` path under the test's own
``tmp_path``, so concurrent pytest-xdist workers never meet, and waits for
its ranks with a time limit of its own: a hung collective fails that test
(every rank is killed in ``finally``) instead of running the suite into its
limit.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_parallel_worker.py")
TIMEOUT_S = 150


def run_ranks(scenario: str, world: int, payload: dict, tmp_path,
              timeout: float = TIMEOUT_S) -> list:
    """Run ``scenario`` in ``world`` gloo ranks -> each rank's result."""
    tmp = str(tmp_path)
    src = os.path.join(tmp, f"{scenario}_in.pt")
    torch.save(payload, src)
    url = "file://" + os.path.join(tmp, f"{scenario}_rendezvous")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    outs = [os.path.join(tmp, f"{scenario}_out{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, scenario, str(r), str(world), url, src,
         outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True, cwd=tmp) for r in range(world)]
    logs = []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=timeout)
            logs.append(log)
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(o, weights_only=False) for o in outs]


def assert_ranks_bitwise(results, key="state"):
    """Every rank holds the same tensors under ``key``, bit for bit."""
    first = results[0][key]
    for r, res in enumerate(results[1:], 1):
        assert sorted(res[key]) == sorted(first)
        for k, v in first.items():
            assert torch.equal(res[key][k], v), (r, k)


def assert_metrics_bitwise(results):
    """Every rank reports the same metric bits at every step."""
    for res in results[1:]:
        for a, b in zip(res["metrics"], results[0]["metrics"]):
            assert sorted(a) == sorted(b)
            for k in a:
                assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


# ------------------------------------------------------------ the JAX side
def jax_trainer(spec: dict):
    """The JAX twin of ``torch_parallel_worker.build_trainer(spec)``."""
    from ganode_tpu.models import (PatchImageDiscriminator,
                                   SNImageDiscriminator, SNVideoDiscriminator,
                                   VideoDiscriminator, make_generator)
    from ganode_tpu.train import GANTrainer

    extra = {"n_experts": spec["n_experts"]} if spec.get("n_experts") else {}
    gen = make_generator(spec["motion"], n_channels=1, trunk="mnist28",
                         video_length=spec["T"], dim_z_content=spec["dzc"],
                         dim_z_motion=spec["dzm"], ngf=spec["ngf"], **extra)
    if spec.get("disc", "bn") == "sn":
        dis = (SNImageDiscriminator(ndf=spec["ndf"]),
               SNVideoDiscriminator(ksize=2, ndf=spec["ndf"]))
    else:
        dis = (PatchImageDiscriminator(ndf=spec["ndf"]),
               VideoDiscriminator(ksize=2, ndf=spec["ndf"]))
    return GANTrainer(gen=gen, dis_img=dis[0], dis_vid=dis[1],
                      batch_size=spec["B"], **spec.get("kw", {}))


def batches(spec: dict, seed: int):
    rng = np.random.default_rng(seed)
    d, B, T = spec.get("kw", {}).get("d_iters", 2), spec["B"], spec["T"]
    return (rng.uniform(-1, 1, (d, B, 28, 28, 1)).astype(np.float32),
            rng.uniform(-1, 1, (d, B, T, 28, 28, 1)).astype(np.float32))


def jax_two_steps(spec: dict, carried_ada=None):
    """Two JAX single-device steps through one compiled function with the
    recorders on: the first makes the carried-across state (non-zero Adam
    moments), the second is the step under test -> (state1, state2,
    metrics2, the second step's global noise tape, its batches)."""
    from unittest import mock

    import jax
    import pytest
    from flax import linen as nn

    import ganode_tpu.train.gan as jax_gan
    from torch_parity import AugRecorder, EpsRecorder, NoiseRecorder, np_tree

    tr = jax_trainer(spec)
    kw = spec.get("kw", {})
    d = kw.get("d_iters", 2)
    rec, aug, eps = NoiseRecorder(), AugRecorder(), EpsRecorder()
    b2 = batches(spec, 2)
    with pytest.MonkeyPatch.context() as mp, \
            mock.patch.object(jax_gan, "gradient_penalty", eps), \
            nn.intercept_methods(rec), jax.enable_x64(False):
        aug.patch(mp)
        rec.patch_gru(mp)
        state0 = jax.jit(tr.init_state)(jax.random.PRNGKey(0))
        step = jax.jit(tr.train_step)
        state1, _ = jax.block_until_ready(
            step(state0, *batches(spec, 1), jax.random.PRNGKey(1)))
        jax.effects_barrier()
        if carried_ada is not None:
            state1 = state1.replace(ada={
                k: jax.numpy.asarray(v, jax.numpy.float32)
                for k, v in carried_ada.items()})
        for r in (rec, aug, eps):
            r.log.clear()
        state2, metrics = jax.block_until_ready(
            step(state1, *b2, jax.random.PRNGKey(2)))
        jax.effects_barrier()
    tape = rec.samples(spec["B"], spec["T"], spec["dzc"])
    if kw.get("diffaug"):
        aug.attach(tape, d)
    if kw.get("gp_weight", 0) > 0:
        for noise, e in zip(tape, eps.log):
            noise["gp_eps"] = e
    return np_tree(state1), np_tree(state2), np_tree(metrics), tape, b2


def port_payload(spec: dict, jax_state):
    """The port trainer of ``spec`` carrying ``jax_state`` -> its flat
    state (``torch_parallel_worker.flat_state``)."""
    import torch_parallel_worker as w
    from ganode_tpu_torch import bridge

    _, state = w.build_trainer(spec)
    bridge.gan_state_to_torch(jax_state, state)
    return w.flat_state(state)


def as_jax_dict(spec: dict, flat: dict) -> dict:
    """A rank's flat state in the bridge's JAX form."""
    import torch_parallel_worker as w
    from ganode_tpu_torch import bridge

    _, state = w.build_trainer(spec)
    w.load_flat_state(state, flat)
    return bridge.torch_gan_state_to_jax(state)


def net_dicts(jax_state) -> dict:
    from ganode_tpu_torch import bridge

    out = {}
    for name in bridge.NETS:
        net = getattr(jax_state, name)
        adam = bridge._adam_state(net.opt_state)
        out[name] = {"params": net.params, "batch_stats": net.batch_stats,
                     "opt_state": {"count": adam.count, "mu": adam.mu,
                                   "nu": adam.nu}}
        if getattr(net, "spectral", None) is not None:
            out[name]["spectral"] = net.spectral
    return out
