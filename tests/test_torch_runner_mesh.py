"""The port's training loop over a mesh (``train/runner.py`` with
``config.mesh``) on the CPU, in gloo ranks.

The loop body: a tiny ``mnist_ode`` (ngf = ndf = 4, B = 4, T = 6, d_iters =
2) runs three steps of the JAX runner's loop on one device (batches from the
JAX samplers, keys folded from the step; ``tests/test_infra.py::
test_run_training_over_mesh`` equates it with the same loop over a mesh).
The JAX state after the first step is carried across, and the port's mesh
loop body (``runner.make_mesh_data_step``, what ``run_training`` runs in
each rank) takes the next two with the same global batches and the noise
each JAX step drew, over ``data=2`` and over ``data=2,seq=2``. Losses rtol
1e-4 (``tests/test_infra.py:373``'s bar); parameters, BatchNorm statistics
and Adam moments rtol 1e-4 with the floors of
``tests/test_torch_train_step.py``; the ranks' states and metrics equal bit
for bit.

The loop itself: ``run_training`` over ``data=2`` against the port's
single-process ``run_training`` of the same config (the same batches and
the same noise, drawn as the single run draws them): losses rtol 1e-4,
parameters rtol 1e-3 with an absolute 1e-5 (``tests/test_infra.py``'s
bars); rank 0 alone writes the run's files; a 2 + 2 resume equals 4 straight
steps bit for bit. The refusals: other mesh axes, a mesh whose size is not
the group's, a mesh without a process group.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

import torch_parallel as tp
import torch_parallel_worker as w
from ganode_tpu.train import runner as jax_runner
from ganode_tpu.utils.config import get_config as jax_get_config
from ganode_tpu_torch import bridge
from ganode_tpu_torch.train import runner
from ganode_tpu_torch.utils.config import get_config
from torch_parity import NoiseRecorder, assert_close_tree, np_tree

B, T, DZC = 4, 6, 10
PARITY = dict(batch_size=B, video_length=T, ngf=4, ndf=4, dim_z_content=DZC,
              dim_z_motion=4, d_iters=2)
LOSS_RTOL, RTOL, FLOOR, FLOOR_NU = 1e-4, 1e-4, 1e-5, 1e-4


@pytest.fixture(scope="module")
def jax_steps():
    """Three steps of the JAX runner's loop -> per step (batches, the noise
    the step drew, the state after it, its losses)."""
    config = jax_get_config("mnist_ode", **PARITY)
    trainer = jax_runner.build_trainer(config)
    img_sampler, vid_sampler = jax_runner.build_data(config, synthetic=True)
    key = jax.random.PRNGKey(config.seed)
    rec = NoiseRecorder()
    out = []
    with nn.intercept_methods(rec), jax.enable_x64(False):
        state = jax.jit(trainer.init_state)(key)
        step_fn = jax.jit(trainer.train_step)
        for step in range(3):
            k_img, k_vid, k_train = jax.random.split(
                jax.random.fold_in(key, step), 3)
            images = jax_runner._stack_d_batches(img_sampler, k_img,
                                                 config.d_iters)
            videos = jax_runner._stack_d_batches(vid_sampler, k_vid,
                                                 config.d_iters)
            rec.log = []
            state, metrics = step_fn(state, images, videos, k_train)
            jax.block_until_ready(state)
            jax.effects_barrier()
            out.append({"images": np.asarray(images),
                        "videos": np.asarray(videos),
                        "noise": rec.samples(B, T, DZC),
                        "state": np_tree(state), "metrics": np_tree(metrics)})
    return out


@pytest.mark.parametrize("mesh,world", [("data=2", 2), ("data=2,seq=2", 4)])
def test_mesh_loop_body_matches_the_jax_runner(jax_steps, tmp_path, mesh,
                                               world):
    config = get_config("mnist_ode", **PARITY)
    trainer = runner.build_trainer(config, device="cpu")
    state = trainer.init_state()
    bridge.gan_state_to_torch(jax_steps[0]["state"], state)
    payload = {"config": "mnist_ode", "overrides": {**PARITY, "mesh": mesh},
               "state": w.flat_state(state),
               "steps": [(s["images"], s["videos"], s["noise"])
                         for s in jax_steps[1:]]}
    results = tp.run_ranks("loop_body", world, payload, tmp_path)
    for got, want in zip(results[0]["metrics"], jax_steps[1:]):
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(float(got[k]), float(v),
                                       rtol=LOSS_RTOL, err_msg=k)
    w.load_flat_state(state, results[0]["state"])
    got, want = bridge.torch_gan_state_to_jax(state), jax_steps[-1]["state"]
    assert got["step"] == int(want.step) == 3
    for name, wn in tp.net_dicts(want).items():
        g = got[name]
        assert int(g["opt_state"]["count"]) == int(wn["opt_state"]["count"])
        for part in ("params", "batch_stats"):
            assert_close_tree(g[part], wn[part], RTOL, FLOOR, f"{name}/{part}")
        assert_close_tree(g["opt_state"]["mu"], wn["opt_state"]["mu"], RTOL,
                          FLOOR, f"{name}/mu")
        assert_close_tree(g["opt_state"]["nu"], wn["opt_state"]["nu"], RTOL,
                          FLOOR_NU, f"{name}/nu")
    tp.assert_ranks_bitwise(results)
    tp.assert_metrics_bitwise(results)


def _tiny(**kw):
    base = dict(batch_size=4, video_length=8, ngf=8, ndf=8, dim_z_content=4,
                dim_z_motion=4, d_iters=1, sample_every=0, checkpoint_every=0,
                log_every=1)
    return {**base, **kw}


def _mesh_run(tmp_path, name, workdir, steps, resume=False, **kw):
    payload = {"config": "mnist_ode", "workdir": str(workdir),
               "overrides": _tiny(mesh="data=2", **kw), "steps": steps,
               "resume": resume}
    return tp.run_ranks("runner", 2, payload, tmp_path / name)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """``run_training`` over data=2: 4 straight steps, and 2 then a resume
    to 4 in another workdir."""
    tmp = tmp_path_factory.mktemp("mesh_runs")
    for d in ("a", "b", "c"):
        (tmp / d).mkdir()
    straight = _mesh_run(tmp, "a", tmp / "straight", 4, sample_every=2,
                         checkpoint_every=2)
    first = _mesh_run(tmp, "b", tmp / "resumed", 2)
    resumed = _mesh_run(tmp, "c", tmp / "resumed", 4, resume=True)
    return tmp, straight, first, resumed


def test_run_training_over_a_mesh_matches_the_single_process_run(
        mesh_runs, tmp_path):
    tmp, straight, _, _ = mesh_runs
    single, m1 = runner.run_training(
        get_config("mnist_ode", **_tiny()), str(tmp_path / "single"),
        steps=4, synthetic=True, device="cpu")
    want = w.flat_state(single)
    for k, v in straight[0]["metrics"].items():
        np.testing.assert_allclose(v, m1[k], rtol=1e-4, err_msg=k)
    got = straight[0]["state"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v.is_floating_point():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)
        else:
            assert torch.equal(got[k], v), k
    tp.assert_ranks_bitwise(straight)
    assert straight[0]["metrics"] == straight[1]["metrics"]


def test_rank_zero_alone_writes_the_run(mesh_runs):
    tmp = mesh_runs[0]
    wd = tmp / "straight"
    lines = [json.loads(l) for l in open(wd / "metrics.jsonl")]
    assert [l["step"] for l in lines] == [0, 1, 2, 3]
    assert sorted(os.listdir(wd / "samples")) == ["gensamples_id0.gif",
                                                  "gensamples_id2.gif"]
    assert sorted(os.listdir(wd / "checkpoints")) == ["0", "2", "4"]


def test_a_resume_over_the_mesh_restores_on_every_rank(mesh_runs):
    _, straight, first, resumed = mesh_runs
    assert int(first[0]["state"]["step"]) == 2
    for r in range(2):
        assert int(resumed[r]["state"]["step"]) == 4
        for k, v in straight[r]["state"].items():
            assert torch.equal(resumed[r]["state"][k], v), (r, k)


def test_the_runner_refuses_other_meshes(tmp_path):
    with pytest.raises(ValueError, match="unsupported by the runner"):
        runner._parse_mesh("data=2,model=2")
    assert runner._parse_mesh("data=4,seq=2") == (("data", "seq"), (4, 2))
    with pytest.raises(RuntimeError, match="initialised process group"):
        runner.run_training(get_config("mnist_ode", **_tiny(mesh="data=2")),
                            str(tmp_path / "m"), steps=1, synthetic=True,
                            device="cpu")
    with pytest.raises(AssertionError, match="a mesh of 4 ranks"):
        tp.run_ranks("runner", 2, {
            "config": "mnist_ode", "workdir": str(tmp_path / "w"),
            "overrides": _tiny(mesh="data=4"), "steps": 1, "resume": False},
            tmp_path)
