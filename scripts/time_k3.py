#!/usr/bin/env python3
"""Time K3 (``ganode_tpu_torch.ops.quant.deconv_i8``, the int8 transposed
conv) alone on the card at the distinct layer shapes of one full-width int8
``sample_videos(64)`` of each of ``chip_smoke.py``'s int8 configs (its
``int8_layer_shapes``), with the fused float32 epilogue and ReLU, as the
trunk calls it.

    python scripts/time_k3.py                  # this checkout's port
    python scripts/time_k3.py --root DIR       # another checkout's, e.g. a parent

Each layer: ``chip_smoke.py``'s random codes, zero-padded to the channels the
checkout's own packing pads to, K3's int32 sums held to its plain version
bit for bit, then ``chip_smoke.device_ms``: device ms per call and the
host's µs per call (the wrapper's checks, its plan and the launch, while the
card is still busy). The shapes and timing come from this checkout's
``chip_smoke.py``, the port from ``--root``. Prints the card's name and
power limit, one line per layer, the sums per config, and last one JSON
object. To compare two checkouts, run them in turns on the same card, one
right after another (new, old, old, new).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=REPO, help="the checkout whose port to time")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ganode_tpu_torch.ops import quant
    from ganode_tpu_torch.utils.config import get_config

    card = cs.first_line(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"])
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    layers = {name: cs.int8_layer_shapes(get_config(name))
              for name in cs.INT8_CONFIGS}
    rows = {}
    for shape in dict.fromkeys(sum(layers.values(), [])):
        b, hw, ci, co, k, s, pad = shape
        ci4 = quant.pack_kernel(torch.zeros((ci, 1, 1, 1), dtype=torch.int8)).shape[-1]
        xq, w = (F.pad(t, (0, ci4 - ci)).to(dev)
                 for t in cs.k3_codes(shape, False, g))
        exact = bool(torch.equal(quant.deconv_i8(xq, w, s, pad),
                                 quant.reference_deconv_i8(xq, w, s, pad)))
        a = torch.full((), 0.0123, device=dev)
        sc, bi = torch.rand(co, device=dev), torch.randn(co, device=dev)
        ms, host_us = cs.device_ms(lambda: quant.deconv_i8(
            xq, w, s, pad, a_scale=a, scale=sc, bias=bi, relu=True),
            10 if b > 1024 else 20, with_host=True)
        rows[shape] = {"shape": list(shape), "ci4": ci4, "ms": ms,
                       "host_us": host_us, "exact": exact}
        print(f"B'={b} {hw}x{hw} {ci}->{co} k{k}s{s}p{pad}, read as {ci4} "
              f"channels: {ms * 1e3:.1f} us on the card, {host_us:.1f} us on "
              f"the host, exact {exact}", flush=True)
        del xq, w
        torch.cuda.empty_cache()
    per = {name: sum(rows[s]["ms"] for s in shapes)
           for name, shapes in layers.items()}
    for name, v in per.items():
        print(f"{name}: K3 {v:.4f} ms per int8 sample_videos(64)", flush=True)
    print(json.dumps({"root": os.path.abspath(args.root), "card": card,
                      "ms_per_call": per, "layers": list(rows.values())}),
          flush=True)
    return 0 if all(r["exact"] for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
