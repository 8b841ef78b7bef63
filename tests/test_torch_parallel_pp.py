"""The port's pipeline schedule (``parallel/pipeline.py``) and pipelined
trunk serving (``models/pipeline.py``) on the CPU over gloo, held against
the JAX package.

``pipeline_apply``: the four heterogeneous dense stages of
``tests/test_infra.py::TestParallel::test_pp_pipeline_matches_sequential_
and_grads`` (7 -> 16 -> 5 -> 12 -> 3, tanh), their flax weights, over a
4-rank 'pipe' mesh: the forward at 4 microbatches against JAX's
``pipeline_apply`` and the sequential composition (rtol 1e-5, atol 1e-6),
the gradient of sum(out^2) at 2 microbatches against JAX's sequential
gradient (rtol 1e-4, atol 1e-6); each rank returns its own stage's
gradients.

``pipelined_sample_videos``: a ``dcgan64`` ``ode`` generator (ngf 8, T 8,
4 clips) from JAX's init, over a (data=2, pipe=2) mesh with 4 microbatches,
against JAX's eval-mode ``sample_videos`` on the noise it drew (rtol 1e-6,
atol 1e-6: ``tests/test_infra.py``'s bar).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

import torch_parallel as tp
from ganode_tpu.models import make_generator as jax_make_generator
from ganode_tpu.parallel import make_mesh as jax_make_mesh
from ganode_tpu.parallel import pipeline_apply as jax_pipeline_apply
from ganode_tpu_torch import bridge
from torch_parity import record_noise

DIMS = [(7, 16), (16, 5), (5, 12), (12, 3)]


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    mods = [nn.Dense(o) for _, o in DIMS]
    with jax.enable_x64(False):   # float32, whatever other files enabled
        x0 = jax.random.normal(jax.random.PRNGKey(0), (8, 7))
        params, cur = [], x0
        for m, (i, o) in zip(mods, DIMS):
            v = m.init(jax.random.PRNGKey(i * o), cur)
            params.append(v["params"])
            cur = m.apply(v, cur)
        fns = [lambda p, x, m=m: jnp.tanh(m.apply({"params": p}, x))
               for m in mods]

        def seq(ps, x):
            for f, p in zip(fns, ps):
                x = f(p, x)
            return x

        mesh = jax_make_mesh(4, ("pipe",))
        want = {"seq": np.asarray(seq(params, x0)),
                "pipe": np.asarray(jax_pipeline_apply(fns, params, x0, mesh,
                                                      n_microbatches=4)),
                "grads": jax.tree.map(np.asarray, jax.grad(
                    lambda ps: jnp.sum(seq(ps, x0) ** 2))(params))}
    payload = {"x": np.asarray(x0),
               "params": [{k: np.asarray(v) for k, v in p.items()}
                          for p in params]}
    got = tp.run_ranks("pipe", 4, payload, tmp_path_factory.mktemp("pipe"))
    return want, got


def test_pipeline_forward_matches_sequential_and_jax(dense):
    want, got = dense
    for res in got:  # the result is replicated on every rank
        out = res["out"].numpy()
        np.testing.assert_allclose(out, want["seq"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out, want["pipe"], rtol=1e-5, atol=1e-6)


def test_pipeline_gradients_match_the_sequential_gradient(dense):
    want, got = dense
    for i, res in enumerate(got):
        for k in ("kernel", "bias"):
            np.testing.assert_allclose(res["grads"][k].numpy(),
                                       want["grads"][i][k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"stage {i} {k}")


def test_pipelined_trunk_matches_eval_sample_videos(tmp_path):
    s = {"T": 8, "dzc": 10, "dzm": 8, "ngf": 8, "n": 4}
    gen = jax_make_generator("ode", n_channels=3, trunk="dcgan64",
                             video_length=s["T"], dim_z_content=s["dzc"],
                             dim_z_motion=s["dzm"], ngf=s["ngf"])
    k = jax.random.PRNGKey(0)
    with jax.enable_x64(False):
        vs = jax.jit(lambda k: gen.init({"params": k, "sample": k}, 2))(k)
    (want, _), rec = record_noise(
        jax.jit(lambda v, sk: gen.apply(v, s["n"], train=False,
                                        method="sample_videos",
                                        rngs={"sample": sk})),
        vs, jax.random.PRNGKey(7))
    (noise,) = rec.samples(s["n"], s["T"], s["dzc"])
    payload = {"gen": s, "shape": (2, 2), "microbatches": 4, "noise": noise,
               "variables": {k: v.numpy() for k, v in bridge.jax_to_torch(
                   jax.tree.map(np.asarray, dict(vs))).items()}}
    got = tp.run_ranks("pipe_trunk", 4, payload, tmp_path)
    for res in got:
        np.testing.assert_allclose(res["videos"].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
