"""The port's data-parallel WGAN-GP step held against the JAX package's
single-device step (``tests/test_infra.py::TestParallel::
test_dp_wgan_gp_sn_ada_ema_step_matches_single_device``'s case): 2 gloo
ranks on the CPU, spectral-norm critics, Wasserstein loss, the gradient
penalty (gp 10), DiffAugment ``color,translation,cutout`` with ADA (``p``
carried in at 0.5 and 0.3, ``ada_step`` 0.1) and EMA 0.999, d_iters 2, from
a carried-across JAX state, the recorded global noise, augmentation draws
and ``gp_eps`` sliced per rank (``test_torch_parallel_dp.py``'s helpers).

Bars: losses rtol 1e-4 (the penalty's double backward sums in another
order); parameters, spectral ``u``, BatchNorm statistics, EMA and first
moments rtol 1e-4 with a floor of 5e-5 of the leaf's largest magnitude
(``tests/test_torch_wgan_step.py``'s), second moments 1e-4; ADA's ``rt``
and ``p`` exact; the ranks bit for bit.
"""
import test_torch_parallel_dp as dp


def test_dp_wgan_gp_sn_ada_ema_step_matches_jax(tmp_path):
    dp._check(*dp._run("wgan", tmp_path))
