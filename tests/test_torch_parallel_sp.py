"""The port's data x sequence-parallel step (``parallel/step.py``, mesh
``data=2, seq=2``: 4 gloo ranks on the CPU) held against the JAX package's
single-device step, which ``tests/test_infra.py::TestParallel::
test_dp_sp_step_matches_single_device`` equates with its dp x sp mesh step.

A tiny ``ode`` trainer (``mnist28``, ngf = ndf = 4, B = 8, T = 6, d_iters =
1, BatchNorm discriminators) from a carried-across JAX state
(``torch_parallel.jax_two_steps``). Rank (i, j) holds 4 clips x frames
[3 j, 3 j + 3) of the real videos and 2 images; its trunk decodes only its
frames, and D_vid sees whole clips gathered over 'seq'.

Bars: those of ``tests/test_torch_parallel_dp.py`` (losses rtol 1e-5;
parameters, statistics and first moments rtol 1e-4 with a floor of 1e-5 of
the leaf's largest magnitude, second moments 1e-4); every rank's state and
metrics equal bit for bit.
"""
import pytest

import test_torch_parallel_dp as dp
import torch_parallel as tp

SPEC = dict(dp.BASE, motion="ode", kw=dict(d_iters=1))


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    s1, s2, metrics, tape, (images, videos) = tp.jax_two_steps(SPEC)
    payload = {"spec": SPEC, "state": tp.port_payload(SPEC, s1),
               "axes": ("data", "seq"), "shape": (2, 2),
               "steps": [(images, videos, tape, None)]}
    return s2, metrics, tp.run_ranks("step", 4, payload,
                                     tmp_path_factory.mktemp("sp"))


def test_each_rank_holds_its_clips_and_frames(sp_run):
    B, T = SPEC["B"], SPEC["T"]
    for res in sp_run[2]:
        images, videos = res["local_shapes"]
        assert images == (1, B // 4, 28, 28, 1)
        assert videos == (1, B // 2, T // 2, 28, 28, 1)
    # D_vid's input is gathered over 'seq' each time it runs
    assert sp_run[2][0]["tally"][0]["all_gather_calls"] >= 3


def test_dp_sp_step_matches_jax(sp_run):
    want_state, want_metrics, results = sp_run
    dp._check(SPEC, want_state, want_metrics, results)
