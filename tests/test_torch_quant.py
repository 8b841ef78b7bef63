"""The int8 serving trunk (``ganode_tpu_torch/ops/quant.py``) against the JAX
package's (``ganode_tpu/ops/quant.py``), on the CPU, where ``deconv_i8`` runs
K3's plain version.

Inputs are numpy-seeded; the trunks are tiny (ngf=8, B'=4) with non-trivial
BatchNorm statistics from one train-mode pass, as ``tests/test_ops.py``'s
``TestInt8Serving`` makes them, and cross to the port through the bridge.

* The plain int8 deconv equals JAX's ``_deconv_i8`` exactly at every
  geometry of ``TRUNK_GEOMETRY`` (k4 s1 p0 from 1x1, k4 s2 p1, the 1x1
  ``Conv_0``), ±127 inputs whose sums pass 2^24 included.
* ``quantize_trunk`` equals JAX's after the bridge's int8 rule: the
  kernel derived from K3's packed copy equals JAX's ``kernel_q`` exactly,
  JAX -> port -> JAX is exact, and the state holds one int8 kernel per
  layer (K3's layout, its padding zero); ``scale`` and ``bias`` too (held at rtol 1e-6
  and found bit-equal: the BatchNorm fold takes a correctly rounded float32
  square root, as XLA does); ``calibrate_act_scales`` at rtol 1e-5 (its
  float convolutions sum in another order in XLA and oneDNN; measured
  2.2e-7).
* ``int8_trunk_apply`` against JAX's on the same z, dynamic and with JAX's
  calibrated scales. Counted over every layer's int8 input: 0 codes differ
  on each trunk (61,496, 61,496 and 254,008 codes for dcgan64, mnist28 and
  dcgan128; 0 too with each side's own calibration), so the frames differ
  only by the final float32 tanh, XLA's against libm's: measured at most
  2.3e-10, held at 1e-6.
* JAX's bars against the float trunk: max < 0.15, mean < 0.02 (dynamic);
  static scales from one batch, on fresh z, < 0.2 / 0.02.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganode_tpu.models.mocogan import DCGANTrunk64 as JaxDCGAN64
from ganode_tpu.models.mocogan import DCGANTrunk128 as JaxDCGAN128
from ganode_tpu.models.mocogan import MNISTTrunk28 as JaxMNIST28
from ganode_tpu.ops import quant as jq
from ganode_tpu_torch import bridge
from ganode_tpu_torch.models.mocogan import (DCGANTrunk64, DCGANTrunk128,
                                             MNISTTrunk28)
from ganode_tpu_torch.ops import quant

DIM_Z = 14
TRUNKS = {"dcgan64": (JaxDCGAN64, DCGANTrunk64, 3),
          "mnist28": (JaxMNIST28, MNISTTrunk28, 1),
          "dcgan128": (JaxDCGAN128, DCGANTrunk128, 3)}
TOL_TANH = 1e-6


@pytest.fixture(scope="module", params=sorted(TRUNKS))
def pair(request):
    """One trunk in both packages with the same weights and BatchNorm
    statistics, two numpy latents (z, and z2 fresh) and JAX's int8 state."""
    name = request.param
    jax_cls, port_cls, n_ch = TRUNKS[name]
    rng = np.random.default_rng(sorted(TRUNKS).index(name))
    z, z2 = (rng.standard_normal((4, DIM_Z)).astype(np.float32)
             for _ in range(2))
    jt = jax_cls(n_channels=n_ch, ngf=8)
    zj = jnp.asarray(z[:, None, None, :])
    variables = jt.init({"params": jax.random.PRNGKey(1)}, zj)
    _, upd = jt.apply(variables, zj, train=True, mutable=["batch_stats"])
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": variables["params"], "batch_stats": upd["batch_stats"]})
    pt = port_cls(n_channels=n_ch, ngf=8, dim_z=DIM_Z)
    pt.load_state_dict(bridge.jax_to_torch(variables))
    pt.eval()
    return {"name": name, "jax": jt, "variables": variables, "port": pt,
            "z": z, "z2": z2,
            "jqp": jq.quantize_trunk(name, variables["params"],
                                     variables["batch_stats"])}


def _jax_apply(p, z, scales=None):
    """JAX's ``int8_trunk_apply`` replayed from its own functions, recording
    each layer's int8 input codes; -> (frames NHWC, codes)."""
    geometry = jq.TRUNK_GEOMETRY[p["name"]]
    h = jnp.asarray(z[:, None, None, :])
    codes = []
    for i, ((_, _, s, pad), layer) in enumerate(zip(geometry,
                                                    p["jqp"]["layers"])):
        hq, a = jq._act_quantize(h, None if scales is None else scales[i])
        codes.append(np.asarray(hq))
        y = jq._deconv_i8(hq, layer["kernel_q"], s, pad)
        h = y.astype(jnp.float32) * (a * layer["scale"]) + layer["bias"]
        if i < len(geometry) - 1:
            h = jax.nn.relu(h)
    if p["name"] == "mnist28":
        h = h[:, 2:-2, 2:-2, :]
    out = np.asarray(jnp.tanh(h))
    want = np.asarray(jq.int8_trunk_apply(p["name"], p["jqp"], z[:, None, None, :],
                                          act_scales=scales))
    np.testing.assert_array_equal(out, want)   # the replay is JAX's function
    return out, codes


def _port_apply(p, z, scales=None):
    codes = []
    qs = quant.quantize_trunk(p["name"], p["port"])
    out = quant.int8_trunk_apply(p["name"], qs, torch.tensor(z),
                                 None if scales is None else
                                 [torch.tensor(np.asarray(s)) for s in scales],
                                 codes=codes)
    return out.permute(0, 2, 3, 1).numpy(), [c.numpy() for c in codes]


GEOMETRIES = [(1, 4, 1, 0), (6, 4, 2, 1), (5, 1, 1, 0)]   # (Hi, k, s, p)


@pytest.mark.parametrize("hi,k,s,p", GEOMETRIES)
@pytest.mark.parametrize("extreme", [False, True])
def test_plain_deconv_equals_jax(hi, k, s, p, extreme):
    rng = np.random.default_rng(hi * 10 + k)
    ci, co = (2048, 5) if extreme else (66, 7)
    if extreme:  # sums of 127 * 127 products past 2^24
        x = np.full((2, hi, hi, ci), 127, np.int8)
        w = np.where(rng.random((k, k, ci, co)) < 0.1, -127, 127).astype(np.int8)
    else:
        x = rng.integers(-127, 128, (3, hi, hi, ci)).astype(np.int8)
        w = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)
    want = np.asarray(jq._deconv_i8(jnp.asarray(x), jnp.asarray(w), s, p))
    kq = torch.tensor(w[::-1, ::-1].transpose(2, 3, 0, 1).copy())
    packed = quant.pack_kernel(kq)
    xq = torch.nn.functional.pad(torch.tensor(x), (0, packed.shape[-1] - ci))
    got = quant.deconv_i8(xq, packed, s, p)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        quant.reference_deconv_i8(xq, packed, s, p).numpy(), want)
    if extreme:
        assert np.abs(want).max() > 2 ** 24


def test_quantize_trunk_equals_jax(pair):
    qs = quant.quantize_trunk(pair["name"], pair["port"])
    want = bridge.int8_state_to_torch(pair["jqp"])
    assert len(qs["layers"]) == len(want["layers"])
    for got, ref in zip(qs["layers"], want["layers"]):
        kq = quant.unpack_kernel(got)
        assert kq.dtype == torch.int8
        assert torch.equal(kq, quant.unpack_kernel(ref))
        assert torch.equal(got["packed"], ref["packed"])
        np.testing.assert_allclose(got["scale"], ref["scale"], rtol=1e-6)
        np.testing.assert_allclose(got["bias"], ref["bias"], rtol=1e-6,
                                   atol=0)
        assert torch.equal(got["scale"], ref["scale"])
        assert torch.equal(got["bias"], ref["bias"])
    # the bridge back gives JAX's state
    back = bridge.int8_state_to_jax(qs)
    for got, ref in zip(back["layers"], pair["jqp"]["layers"]):
        np.testing.assert_array_equal(got["kernel_q"], np.asarray(ref["kernel_q"]))


def test_the_int8_state_holds_each_kernel_once_and_round_trips(pair):
    qs = quant.quantize_trunk(pair["name"], pair["port"])
    jqp = pair["jqp"]["layers"]
    for layer, ref in zip(qs["layers"], jqp):
        k, _, ci, co = np.asarray(ref["kernel_q"]).shape
        assert sorted(layer) == ["bias", "ci", "packed", "scale"]
        # one int8 tensor per layer: K3's packing, padded to 32 channels
        int8 = [v for v in layer.values() if isinstance(v, torch.Tensor)
                and v.dtype == torch.int8]
        assert len(int8) == 1 and layer["ci"] == ci
        assert layer["packed"].shape == (k, k, co, -(-ci // 32) * 32)
        assert not layer["packed"][..., ci:].any()
    for name, state in (("port", qs),
                        ("bridge", bridge.int8_state_to_torch(pair["jqp"]))):
        back = bridge.int8_state_to_jax(state)
        for got, ref in zip(back["layers"], jqp):
            for key in ("kernel_q", "scale", "bias"):
                assert got[key].dtype == np.asarray(ref[key]).dtype, name
                np.testing.assert_array_equal(got[key], np.asarray(ref[key]),
                                              err_msg=f"{name} {key}")


def test_calibrate_act_scales_equals_jax(pair):
    want = jq.calibrate_act_scales(pair["name"], pair["variables"]["params"],
                                   pair["variables"]["batch_stats"],
                                   pair["z"][:, None, None, :])
    got = quant.calibrate_act_scales(pair["name"], pair["port"],
                                     torch.tensor(pair["z"]))
    assert len(got) == len(want) and all(g.ndim == 0 for g in got)
    np.testing.assert_allclose([float(g) for g in got],
                               [float(w) for w in want], rtol=1e-5)


@pytest.mark.parametrize("static", [False, True])
def test_int8_trunk_apply_equals_jax(pair, static):
    scales = (jq.calibrate_act_scales(
        pair["name"], pair["variables"]["params"],
        pair["variables"]["batch_stats"], pair["z"][:, None, None, :])
        if static else None)
    want, want_codes = _jax_apply(pair, pair["z2"], scales)
    got, got_codes = _port_apply(pair, pair["z2"], scales)
    assert got.shape == want.shape
    flipped = sum(int((g[..., :w.shape[-1]] != w).sum())
                  for g, w in zip(got_codes, want_codes))
    assert flipped == 0
    assert all(not g[..., w.shape[-1]:].any()
               for g, w in zip(got_codes, want_codes))   # the padding
    assert np.abs(got - want).max() < TOL_TANH


def test_int8_meets_jaxs_bars_against_the_float_trunk(pair):
    z, z2 = torch.tensor(pair["z"]), torch.tensor(pair["z2"])
    qs = quant.quantize_trunk(pair["name"], pair["port"])
    with torch.no_grad():
        want, want2 = pair["port"](z), pair["port"](z2)
    got = quant.int8_trunk_apply(pair["name"], qs, z)
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got - want).abs()
    assert err.max() < 0.15 and err.mean() < 0.02
    scales = quant.calibrate_act_scales(pair["name"], pair["port"], z)
    err2 = (quant.int8_trunk_apply(pair["name"], qs, z2, scales) - want2).abs()
    assert err2.max() < 0.2 and err2.mean() < 0.02
    err1 = (quant.int8_trunk_apply(pair["name"], qs, z, scales) - want).abs()
    assert err1.max() < 0.15


def test_gres_trunks_have_no_int8_geometry():
    for name in ("gres64", "odegres64"):
        with pytest.raises(ValueError, match="int8 geometry"):
            quant.quantize_trunk(name, {})


def test_deconv_i8_refuses_what_it_does_not_take():
    xq = torch.zeros((2, 3, 3, 8), dtype=torch.int8)
    w = torch.zeros((4, 4, 5, 8), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        quant.deconv_i8(xq.float(), w, 2, 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        quant.deconv_i8(xq[..., :6], w[..., :6], 2, 1)
    with pytest.raises(ValueError, match="epilogue needs"):
        quant.deconv_i8(xq, w, 2, 1, a_scale=torch.tensor(1.0))
    with pytest.raises(ValueError, match="scale and bias"):
        quant.deconv_i8(xq, w, 2, 1, a_scale=torch.tensor(1.0),
                        scale=torch.ones(4), bias=torch.ones(5))
