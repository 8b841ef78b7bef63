"""K3's host-side plan (``ganode_tpu_torch/ops/quant.py::k3_plan``) on the
CPU: the tile plan the wrapper computes and passes to
``csrc/int8_deconv.cu``, which only the card can run.

At each of the 16 layer shapes of the full-width int8 trunks (``ucf_ode``,
``mnist_ode``, ``ucf_wgan_gp_128``; B' = 64 T frames) and at the card
tests' shapes (``tests/test_torch_cuda.py``):

* the plan meets TMA's and ``wgmma``'s limits, read from the ints the C
  entry point encodes its tensor maps from (``K3Plan.args``): every global
  stride a multiple of 16 bytes (below 2^40), box dims in 1..256, the inner
  box exactly the swizzle span of its row width (32 or 128 bytes), 128 rows
  per tile, N tiles legal for ``m64nNk32`` s8 and K chunks a multiple of
  32 bytes dividing the padded channels, the shared memory within a
  block's 227 KB, the tile counts within CUDA's limits; the last layers take
  the bytes route (the kernel in shared memory) and every
  ``ConvTranspose_0`` the one-tap GEMM;
* a pure-torch simulation of the plan, at the shape with the batch cut to
  2 or 3, gives exactly ``reference_deconv_i8``'s sums, random codes and
  ±127 ones (sums past 2^24). The simulation does what the kernel is
  planned to do: per parity class and tile, each tap's input box gathered
  with zero fill at the plan's coordinates (negative at the top and left),
  a tap whose box lies wholly outside the input skipped (its box must be
  zeros), the weight box with rows beyond the map zero, int64 products
  summed chunk by chunk of BK channels, and only the rows and columns inside
  the output stored; on the bytes route each s x s quad's window of input
  pixels, 16 channels at a time.
"""
import itertools

import pytest
import torch
import torch.nn.functional as F

from ganode_tpu_torch.models.mocogan import make_trunk
from ganode_tpu_torch.ops import quant
from ganode_tpu_torch.utils.config import get_config

CONFIGS = ("ucf_ode", "mnist_ode", "ucf_wgan_gp_128")
# (B, Hi, Ci4, Co, k, s, p) of tests/test_torch_cuda.py's K3 cases: the
# first five, then shapes that cross tile edges (M not a multiple of 64, Co
# not a multiple of the N tile, two W tiles, Ci4 not a multiple of 16,
# classes with one and two taps or none, a 1x1 input with p > 0)
CARD_SHAPES = [(70, 1, 68, 130, 4, 1, 0), (9, 4, 64, 64, 4, 2, 1),
               (5, 7, 32, 3, 4, 2, 1), (3, 6, 12, 1, 1, 1, 0),
               (2, 2, 2048, 70, 4, 2, 1), (3, 5, 64, 96, 4, 2, 1),
               (2, 4, 64, 200, 4, 2, 1), (1, 130, 32, 16, 4, 2, 1),
               (4, 3, 20, 40, 4, 2, 1), (2, 5, 32, 5, 3, 2, 1),
               (2, 3, 32, 16, 1, 2, 0), (3, 1, 64, 24, 4, 1, 1)]
# wgmma.mma_async m64nNk32 with s8 operands
WGMMA_S8_N = {8, 16, 24, 32, *range(48, 257, 16)}
SMEM_PER_BLOCK = 232448


def trunk_layer_shapes():
    """``(B', Hi, Ci4, Co, k, s, p)`` of every K3 call of one int8
    ``sample_videos(64)`` of each config, the weights' shapes from the
    trunk built on the meta device (as ``chip_smoke.py`` does)."""
    shapes = []
    for name in CONFIGS:
        cfg = get_config(name)
        dim_z = cfg.dim_z_content + cfg.dim_z_category + cfg.dim_z_motion
        with torch.device("meta"):
            sd = make_trunk(cfg.trunk, cfg.n_channels, cfg.ngf, dim_z).state_dict()
        hw = 1
        for conv, _, s, p in quant.TRUNK_GEOMETRY[cfg.trunk]:
            w = sd[f"{conv}.weight"]
            ci, co = ((w.shape[1], w.shape[0]) if conv.startswith("Conv_")
                      else (w.shape[0], w.shape[1]))
            k = w.shape[-1]
            shapes.append((name, conv, (64 * cfg.video_length, hw, ci, co, k, s, p)))
            hw = (hw - 1) * s - 2 * p + k
    return shapes


TRUNK = trunk_layer_shapes()
ALL_SHAPES = [shape for _, _, shape in TRUNK] + CARD_SHAPES
IDS = [f"{n}-{c}" for n, c, _ in TRUNK] + [
    "card-" + "-".join(map(str, s)) for s in CARD_SHAPES]


def _plan(shape):
    b, hi, ci4, co, k, s, p = shape
    return quant.k3_plan(b, hi, hi, ci4, co, k, s, p)


def test_there_are_16_trunk_layers():
    assert len(TRUNK) == 16


def _window(plan):
    """The input rows (and columns) an s x s quad of the bytes route reads,
    relative to its quad: ``(lo, size)``."""
    ds = [dy for _, _, taps in plan.classes for _, _, dy, _ in taps]
    return min(ds), max(ds) - min(ds) + 1


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=IDS)
def test_the_plan_meets_tma_and_wgmma_limits(shape):
    b, hi, ci, co, k, s, p = shape
    plan = _plan(shape)
    assert plan.ci4 % 32 == 0 and plan.ci4 >= ci and plan.ci4 - ci < 32
    assert (plan.ho, plan.wo) == ((1, 1) if plan.gemm else
                                  ((hi - 1) * s - 2 * p + k,) * 2)
    args = plan.args
    assert len(args) == len(quant.PLAN_FIELDS)
    assert all(isinstance(a, int) and -2 ** 31 <= a < 2 ** 31 for a in args)
    f = dict(zip(quant.PLAN_FIELDS, args))
    assert (f["B"], f["Hi"], f["Wi"], f["Ci4"], f["Cs"]) == (b, hi, hi, plan.ci4, co)
    if plan.route == "bytes":
        assert f["route"] == 1 and (k, s, p, co) in quant.BYTES_KERNELS
        assert (f["K"], f["s"], f["p"], f["N"]) == (k, s, p, co)
        assert k * k * co * plan.ci4 <= quant.BYTES_MAX_SMEM
        # the window csrc/int8_deconv.cu compiles for (k, s, p)
        assert _window(plan) == ((-1, 3) if (k, s, p) == (4, 2, 1) else (0, 1))
        return
    assert plan.route == "tensor_core" and f["route"] == 0
    assert plan.gemm == (hi == 1 and p == 0)
    assert f["N"] == plan.n == (k * k * co if plan.gemm else co)
    # the input map (C, W, H, B) and the weight map (Ci4, rows, taps):
    # global strides multiples of 16 bytes, below 2^40, and those of the
    # contiguous NHWC codes and (k, k, Co, Ci4) weights
    x_strides = (f["xStrideW"], f["xStrideH"], f["xStrideB"])
    w_strides = (f["wStrideRow"], f["wStrideTap"])
    for stride in (*x_strides, *w_strides):
        assert stride % 16 == 0 and stride < 2 ** 40
    assert x_strides == (plan.ci4, hi * plan.ci4, hi * hi * plan.ci4)
    assert f["mapRows"] * f["mapTaps"] == k * k * co
    assert w_strides == (plan.ci4, f["mapRows"] * plan.ci4)
    # boxes (BK, boxW, boxH, boxB) and (BK, BN, 1): dims in 1..256, the
    # inner box one swizzle span
    bk, box_w, box_h, box_b = f["BK"], f["boxW"], f["boxH"], f["boxB"]
    for box in ((bk, box_w, box_h, box_b), (bk, f["BN"], 1)):
        assert all(1 <= d <= 256 for d in box)
    assert f["swizzle"] == bk and bk in (32, 128)
    assert box_w * box_h * box_b == quant.TC_ROWS
    # wgmma m64nNk32 s8: N legal, K a multiple of 32 bytes dividing Ci4
    assert f["BN"] in WGMMA_S8_N and f["BN"] in quant.TC_BN
    assert bk in quant.TC_BK and plan.ci4 % bk == 0
    assert (plan.bn, plan.bk, plan.box) == (f["BN"], bk, (bk, box_w, box_h, box_b))
    # csrc/int8_deconv.cu::tc_smem_bytes: the ring (3 stages at N 64, else 4),
    # the output tile (rows of N + 8 words), scales, biases, row offsets
    stages = 3 if plan.bn == 64 else 4
    smem = (stages * (quant.TC_ROWS + plan.bn) * bk
            + 4 * quant.TC_ROWS * (plan.bn + 8) + 8 * plan.bn
            + 8 * quant.TC_ROWS + 16 * stages + 1024)
    assert smem <= SMEM_PER_BLOCK
    # grid: every output row and column in some tile
    tiles_w, tiles_h, tiles_b, tiles_n = plan.tiles
    hq, wq = -(-plan.ho // plan.s), -(-plan.wo // plan.s)
    assert tiles_w * box_w >= wq and tiles_h * box_h >= hq
    assert tiles_b * box_b >= b and tiles_n * plan.bn >= plan.n
    assert (f["tilesW"], f["tilesH"], f["tilesN"]) == (tiles_w, tiles_h, tiles_n)
    assert (f["gridX"], f["gridZ"]) == plan.grid == (
        tiles_w * tiles_h * tiles_b * tiles_n, plan.s * plan.s)
    assert f["gridX"] * f["gridZ"] < 2 ** 31


def test_routes_of_the_trunk_layers():
    for name, conv, shape in TRUNK:
        plan = _plan(shape)
        last = conv == quant.TRUNK_GEOMETRY[get_config(name).trunk][-1][0]
        assert plan.route == ("bytes" if last else "tensor_core"), (name, conv)
        assert plan.gemm == (conv == "ConvTranspose_0"), (name, conv)


def _box(x, b0, y0, x0, nb, nh, nw):
    """x[b0:b0+nb, y0:y0+nh, x0:x0+nw, :] with zeros outside, as TMA fills
    a box (coordinates may be negative)."""
    b, hi, wi, c = x.shape
    out = torch.zeros((nb, nh, nw, c), dtype=x.dtype)
    sb = slice(max(b0, 0), min(b0 + nb, b))
    sy = slice(max(y0, 0), min(y0 + nh, hi))
    sx = slice(max(x0, 0), min(x0 + nw, wi))
    if sb.start < sb.stop and sy.start < sy.stop and sx.start < sx.stop:
        out[sb.start - b0:sb.stop - b0, sy.start - y0:sy.stop - y0,
            sx.start - x0:sx.stop - x0] = x[sb, sy, sx]
    return out


def simulate_tensor_core(plan, x, w):
    """The tensor-core route of ``plan`` on ``x (B, Hi, Wi, Ci4)`` and
    ``w (k, k, Co, Ci4)`` (int8, padded to ``plan.ci4``) -> int64 sums."""
    bk, box_w, box_h, box_b = plan.box
    tiles_w, tiles_h, tiles_b, tiles_n = plan.tiles
    wmap = w.long().reshape(plan.map_taps, plan.map_rows, plan.ci4)
    x = x.long()
    b = x.shape[0]
    out = torch.zeros((b, plan.ho, plan.wo, plan.n), dtype=torch.int64)
    for ry, rx, taps in plan.classes:
        hq = -(-(plan.ho - ry) // plan.s)
        wq = -(-(plan.wo - rx) // plan.s)
        for tb, th, tw, tn in itertools.product(range(tiles_b), range(tiles_h),
                                                range(tiles_w), range(tiles_n)):
            b0, qy0, qx0, n0 = tb * box_b, th * box_h, tw * box_w, tn * plan.bn
            acc = torch.zeros((quant.TC_ROWS, plan.bn), dtype=torch.int64)
            for ky, kx, dy, dx in taps:
                iy0, ix0 = qy0 + dy, qx0 + dx
                a = _box(x, b0, iy0, ix0, box_b, box_h, box_w)
                if iy0 >= plan.hi or iy0 + box_h <= 0 or ix0 >= plan.wi \
                        or ix0 + box_w <= 0:
                    assert not a.any()  # skipped: wholly padding
                    continue
                a = a.reshape(quant.TC_ROWS, plan.ci4)
                wt = wmap[ky * plan.k + kx, n0:n0 + plan.bn]
                wt = F.pad(wt, (0, 0, 0, plan.bn - wt.shape[0]))  # rows past the map
                for c0 in range(0, plan.ci4, bk):
                    acc += a[:, c0:c0 + bk] @ wt[:, c0:c0 + bk].T
            acc = acc.reshape(box_b, box_h, box_w, plan.bn)
            nb, nh, nw = (min(box_b, b - b0), min(box_h, hq - qy0),
                          min(box_w, wq - qx0))
            nn = min(plan.bn, plan.n - n0)
            if min(nb, nh, nw, nn) <= 0:
                continue
            oy = torch.arange(qy0, qy0 + nh) * plan.s + ry
            ox = torch.arange(qx0, qx0 + nw) * plan.s + rx
            out[b0:b0 + nb, oy[:, None], ox[None, :], n0:n0 + nn] = \
                acc[:nb, :nh, :nw, :nn]
    if plan.gemm:
        out = out.reshape(b, plan.n // plan.co, plan.co)
        side = int(round((plan.n // plan.co) ** 0.5))
        out = out.reshape(b, side, side, plan.co)
    return out


def simulate_bytes(plan, x, w):
    """The bytes route: per s x s quad, its window of input pixels 16
    channels at a time, each output of the quad summing its taps."""
    lo, size = _window(plan)
    x, w = x.long(), w.long()
    b = x.shape[0]
    hq, wq = -(-plan.ho // plan.s), -(-plan.wo // plan.s)
    out = torch.zeros((b, plan.ho, plan.wo, plan.co), dtype=torch.int64)
    for ry, rx, taps in plan.classes:
        acc = torch.zeros((b, hq, wq, plan.co), dtype=torch.int64)
        for ky, kx, dy, dx in taps:
            assert lo <= dy < lo + size and lo <= dx < lo + size
            a = _box(x, 0, dy, dx, b, hq, wq)
            for c0 in range(0, plan.ci4, 16):
                acc += a[..., c0:c0 + 16] @ w[ky, kx, :, c0:c0 + 16].T
        oy = torch.arange(hq) * plan.s + ry
        ox = torch.arange(wq) * plan.s + rx
        keep_y, keep_x = oy < plan.ho, ox < plan.wo
        out[:, oy[keep_y][:, None], ox[keep_x][None, :]] = \
            acc[:, keep_y][:, :, keep_x]
    return out


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("shape", ALL_SHAPES, ids=IDS)
def test_a_simulation_of_the_plan_gives_the_plain_sums(shape, extreme):
    b, hi, ci4, co, k, s, p = shape
    b = min(b, 3 if b % 2 else 2)
    g = torch.Generator().manual_seed(hi * 1000 + co)
    if extreme:  # every product 127^2 in magnitude
        x = torch.full((b, hi, hi, ci4), 127, dtype=torch.int8)
        w = torch.where(torch.rand((k, k, co, ci4), generator=g) < 0.25,
                        -127, 127).to(torch.int8)
    else:
        x = torch.randint(-127, 128, (b, hi, hi, ci4), generator=g,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, k, co, ci4), generator=g,
                          dtype=torch.int8)
    plan = quant.k3_plan(b, hi, hi, ci4, co, k, s, p)
    xp, wp = (F.pad(t, (0, plan.ci4 - ci4)) for t in (x, w))
    got = (simulate_bytes if plan.route == "bytes" else simulate_tensor_core)(
        plan, xp, wp)
    want = quant.reference_deconv_i8(x, w, s, p)
    assert got.shape == want.shape
    assert torch.equal(got, want.long())
    if extreme and ci4 >= 1024:
        assert want.abs().max() > 2 ** 24
