#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``ganode_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``). In order, each phase
printing one line before the next starts:

1. arms a watchdog: a phase that hangs for 240 s dumps its traceback and
   exits non-zero;
2. prints the card's name and power limit (``nvidia-smi``), torch, CUDA and
   nvcc versions;
3. builds the kernels from ``ganode_tpu_torch/csrc`` and prints the seconds;
4. holds K1 (fused RK4) and K2 (fused GRU) against their plain PyTorch
   versions on the card, at the serving shape and at a ragged one;
5. serves ``ucf_ode`` at full width through ``GeneratorSession``, shows K1's
   counter rose, and holds the videos against the same noise decoded with the
   plain RK4 (and, for 2 clips, against the CPU);
6. the same for ``mnist_gru`` with K2;
7. times each kernel, its plain version, cuDNN's GRU as K2's yardstick, and
   ``sample_videos(64)`` for both configs, with CUDA events after warm-up.

Float32 throughout. Matrix products run in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``); the correctness checks
also turn TF32 off for cuDNN's convolutions, and the serving times are taken
with cuDNN's TF32 both off and on (PyTorch's default).

The last two lines of standard output are one JSON object with a record per
kernel and ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before those lines. Writes nothing but ``ganode_tpu_torch/_build/``.
"""
from __future__ import annotations

import faulthandler
import importlib.metadata
import json
import os
import subprocess
import sys
import time

WATCHDOG_S = 240
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# (non-tensor-core) FLOP/s, for the roofline bounds.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
TOL_TRAJ = 1e-5    # kernel vs plain trajectories, float32 (same GPU inputs)
# Videos after the trunk: the 1e-6-class motion difference passes through five
# float32 (TF32 off) deconvolutions, and the CPU check sums in another order.
TOL_VIDEO = 1e-4


def phase(name: str):
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    print(f"== {name}", flush=True)


def say(*parts):
    print(*parts, flush=True)


def require(cond, what):
    """A failed check ends the run with a non-zero exit (kept under -O)."""
    if not cond:
        raise SystemExit(f"FAIL: {what}")


def first_line(cmd) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    return lines[0].strip() if out.returncode == 0 and lines else "unknown"


def rk4_cost(b, d, h, t):
    """(operations, bytes) of one K1 call: per RHS evaluation two products
    (2*B*D*H each), two bias adds and a tanh; 15 per-element ops for the four
    stage updates of an interval; inputs read once, (T, B, D) written once."""
    ops = (t - 1) * (4 * (4 * b * d * h + 2 * b * h + b * d) + 15 * b * d)
    nbytes = 4 * (b * d + 2 * d * h + h + d + t * b * d)
    return ops, nbytes


def gru_cost(b, d, t):
    """(operations, bytes) of one K2 call: per step two (B, D) x (D, 3D)
    products, two bias adds, ~10 per-element gate ops; inputs read once,
    (T, B, D) written once."""
    ops = t * (2 * 2 * b * d * 3 * d + 2 * b * 3 * d + 10 * b * d)
    nbytes = 4 * (b * d + t * b * d + 2 * d * 3 * d + 2 * 3 * d + t * b * d)
    return ops, nbytes


def bound_ms(ops, nbytes):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    faulthandler.enable()
    phase("watchdog armed: %d s per phase" % WATCHDOG_S)

    phase("device")
    import torch

    require(torch.cuda.is_available(),
            "torch.cuda.is_available() is false; this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from ganode_tpu_torch.compat import GeneratorSession
    from ganode_tpu_torch.models import generator_for_config
    from ganode_tpu_torch.ops import _build, fused_gru, fused_rk4
    from ganode_tpu_torch.ops import (fused_gru_motion, fused_rk4_motion,
                                      reference_gru_motion, reference_rk4_motion)
    from ganode_tpu_torch.utils import layout
    from ganode_tpu_torch.utils.config import get_config

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = first_line(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"])
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    say(smi)
    try:  # recorded only; nothing here imports triton
        triton_v = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton_v = "not installed"
    say(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} triton {triton_v} "
        f"devices {torch.cuda.device_count()}")
    try:
        nvcc_v = subprocess.run([_build.find_nvcc(), "--version"],
                                capture_output=True, text=True).stdout
        say("nvcc --version:", " | ".join(l.strip() for l in nvcc_v.splitlines()
                                          if l.strip()))
    except RuntimeError as e:
        say(f"nvcc: {e}")

    phase("build")
    _build.load_library()
    say(f"built {_build.library_path().name} in {_build.build_seconds:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("  ptxas:", line.strip())

    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def rk4_inputs(b, d, h, t):
        return (randn(b, d), randn(d, h, scale=0.4), randn(h, scale=0.1),
                randn(h, d, scale=0.4), randn(d, scale=0.1),
                torch.linspace(0.0, 1.0, t))

    def gru_inputs(b, d, t):
        return (randn(b, d), randn(t, b, d), randn(d, 3 * d, scale=0.3),
                randn(d, 3 * d, scale=0.3), randn(3 * d, scale=0.1),
                randn(3 * d, scale=0.1))

    errs = {}
    phase("kernels vs plain versions")
    for shape in ((64, 16, 16, 16), (5, 10, 24, 6)):
        args = rk4_inputs(*shape)
        before = fused_rk4.launches
        got = fused_rk4_motion(*args)
        torch.cuda.synchronize()
        require(fused_rk4.launches == before + 1, "K1 counter did not rise")
        want = reference_rk4_motion(*args)
        err = (got - want).abs().max().item()
        say(f"K1 rk4_motion B,D,H,T={shape}: max|kernel-plain| = {err:.3e} "
            f"(tol {TOL_TRAJ})")
        require(got.shape == want.shape and err < TOL_TRAJ,
                f"{tuple(got.shape)} vs {tuple(want.shape)}, err {err}")
        errs["rk4"] = max(errs.get("rk4", 0.0), err)
    for shape in ((64, 16, 16), (5, 10, 6)):
        args = gru_inputs(*shape)
        before = fused_gru.launches
        got = fused_gru_motion(*args)
        torch.cuda.synchronize()
        require(fused_gru.launches == before + 1, "K2 counter did not rise")
        want = reference_gru_motion(*args)
        err = (got - want).abs().max().item()
        say(f"K2 gru_motion B,D,T={shape}: max|kernel-plain| = {err:.3e} "
            f"(tol {TOL_TRAJ})")
        require(got.shape == want.shape and err < TOL_TRAJ,
                f"{tuple(got.shape)} vs {tuple(want.shape)}, err {err}")
        errs["gru"] = max(errs.get("gru", 0.0), err)

    def decode(gen, zc, zm):
        """Independent composition of the generator: content || motion per
        frame, then the trunk; (n, T, H, W, C)."""
        n, t = zm.shape[:2]
        z = torch.cat([zc.repeat_interleave(t, 0), zm.reshape(n * t, -1)], 1)
        h = gen.main(z)
        return h.reshape(n, t, *h.shape[1:]).permute(0, 1, 3, 4, 2)

    def plain_ode(gen, zc, x0, t):
        m = gen.motion
        l0, l1 = m.ode_fn.Dense_0, m.ode_fn.Dense_1
        zs = reference_rk4_motion(m.WarmupMLP_0(x0), l0.weight.t(), l0.bias,
                                  l1.weight.t(), l1.bias,
                                  torch.linspace(0.0, 1.0, t))
        return decode(gen, zc, zs.transpose(0, 1))

    def plain_gru(gen, zc, h0, e):
        c = gen.motion.gru
        hs = reference_gru_motion(h0, e, c.wi, c.wh, c.bi, c.bh)
        return decode(gen, zc, hs.transpose(0, 1))

    def serve(config_name, counter, want_shape, noise, plain):
        cfg = get_config(config_name)
        sess = GeneratorSession(generator_for_config(cfg, device=dev), seed=0,
                                device=dev)
        torch.backends.cudnn.allow_tf32 = False
        fused_rk4.launches = fused_gru.launches = 0
        videos, _ = sess.sample_videos(64)
        torch.cuda.synchronize()
        launches = counter.launches
        other = (fused_gru if counter is fused_rk4 else fused_rk4).launches
        say(f"{config_name}: sample_videos(64) -> {tuple(videos.shape)} "
            f"channels-first; kernel launches {launches}, other kernel {other}")
        require(launches >= 1, f"{config_name} did not launch its kernel")
        v = layout.video_from_torch(videos)
        require(tuple(v.shape) == want_shape, f"shape {tuple(v.shape)}")
        require(bool(torch.isfinite(v).all()) and v.abs().max().item() <= 1.0,
                "videos not finite or outside [-1, 1]")
        gen = sess.gen
        with torch.no_grad():
            zc = torch.randn((64, cfg.dim_z_content), generator=g).to(dev)
            v_k, _ = gen.sample_videos(64, z_content=zc, **noise)
            v_p = plain(gen, zc, **noise)
            err = (v_k - v_p).abs().max().item()
            gen_cpu = generator_for_config(cfg, device="cpu").eval()
            v_c, _ = gen_cpu.sample_videos(
                2, z_content=zc[:2].cpu(),
                **{k: (a[:, :2] if k == "e" else a[:2]).cpu()
                   for k, a in noise.items()})
            err_cpu = (v_k[:2].cpu() - v_c).abs().max().item()
        say(f"{config_name}: kernel path vs plain path max|diff| = {err:.3e}; "
            f"card vs CPU (2 clips) = {err_cpu:.3e} (tol {TOL_VIDEO}, TF32 off)")
        require(err < TOL_VIDEO and err_cpu < TOL_VIDEO,
                f"video errors {err}, {err_cpu}")
        return sess, launches

    phase("serve ucf_ode at full width (dcgan64, ngf=64, 3 ch, T=16)")
    gn = torch.Generator().manual_seed(1)
    noise_ode = {"x0": torch.randn((64, 16), generator=gn).to(dev)}
    sess_ode, launches_k1 = serve("ucf_ode", fused_rk4, (64, 16, 64, 64, 3),
                                  noise_ode, lambda gen, zc, x0: plain_ode(gen, zc, x0, 16))

    phase("serve mnist_gru at full width (mnist28, ngf=64, 1 ch, T=16)")
    noise_gru = {"h0": torch.randn((64, 16), generator=gn).to(dev),
                 "e": torch.randn((16, 64, 16), generator=gn).to(dev)}
    sess_gru, launches_k2 = serve("mnist_gru", fused_gru, (64, 16, 28, 28, 1),
                                  noise_gru, plain_gru)

    phase("timing (CUDA events, after warm-up)")

    def events_ms(fn, n):
        """Mean ms per call between CUDA events around n calls: what a caller
        sees, host overhead included when the card outpaces the host."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    def device_ms(fn, n):
        """Mean device ms per call: the calls are queued behind a spin kernel
        that outlasts their enqueue, so the events see back-to-back work."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(enqueue_s * 1.5 * 2.0e9) + 1_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    k1_args = rk4_inputs(64, 16, 16, 16)
    k2_args = gru_inputs(64, 16, 16)
    with torch.no_grad():
        k1_ms = device_ms(lambda: fused_rk4_motion(*k1_args), 200)
        k1_call_ms = events_ms(lambda: fused_rk4_motion(*k1_args), 200)
        k1_plain_ms = events_ms(lambda: reference_rk4_motion(*k1_args), 10)
        k2_ms = device_ms(lambda: fused_gru_motion(*k2_args), 200)
        k2_call_ms = events_ms(lambda: fused_gru_motion(*k2_args), 200)
        k2_plain_ms = events_ms(lambda: reference_gru_motion(*k2_args), 10)
        h0, e, wi, wh, bi, bh = k2_args
        lib_gru = torch.nn.GRU(16, 16).to(dev)
        lib_gru.weight_ih_l0.copy_(wi.t())
        lib_gru.weight_hh_l0.copy_(wh.t())
        lib_gru.bias_ih_l0.copy_(bi)
        lib_gru.bias_hh_l0.copy_(bh)
        lib_err = (lib_gru(e, h0[None])[0] - reference_gru_motion(*k2_args)).abs().max().item()
        k2_lib_ms = device_ms(lambda: lib_gru(e, h0[None]), 200)
    (b, d), hd, t = k1_args[0].shape, k1_args[1].shape[1], k1_args[5].shape[0]
    k1_bound, k1_by = bound_ms(*rk4_cost(b, d, hd, t))
    t, b, d = k2_args[1].shape
    k2_bound, k2_by = bound_ms(*gru_cost(b, d, t))
    say(f"K1 rk4_motion B=64 D=H=16 T=16: kernel {k1_ms * 1e3:.2f} us on the "
        f"device, {k1_call_ms * 1e3:.2f} us per wrapper call; plain "
        f"{k1_plain_ms * 1e3:.1f} us; bound {k1_bound * 1e3:.4f} us ({k1_by}); {card}")
    say(f"K2 gru_motion B=64 D=16 T=16: kernel {k2_ms * 1e3:.2f} us on the "
        f"device, {k2_call_ms * 1e3:.2f} us per wrapper call; plain "
        f"{k2_plain_ms * 1e3:.1f} us; cuDNN nn.GRU {k2_lib_ms * 1e3:.2f} us "
        f"(max|nn.GRU-plain| {lib_err:.2e}); bound {k2_bound * 1e3:.4f} us "
        f"({k2_by}); {card}")

    serving = {}
    for name, sess in (("ucf_ode", sess_ode), ("mnist_gru", sess_gru)):
        gen = sess.gen
        with torch.no_grad():
            motion_ms = events_ms(
                lambda: gen.motion(64, 16, generator=sess.generator), 20)
            z, _ = gen.sample_z_video(64, 16, generator=sess.generator)
        say(f"{name} motion sampler (64 clips, warm-up MLP + kernel): "
            f"{motion_ms:.3f} ms per call; {card}")
        serving[f"{name} motion"] = motion_ms
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            tag = f"cuDNN TF32 {'on' if tf32 else 'off'}"
            ms = events_ms(lambda: sess.sample_videos(64), 10)
            with torch.no_grad():
                trunk_ms = events_ms(lambda: gen.main(z), 10)
            serving[f"{name} tf32={'on' if tf32 else 'off'}"] = ms
            serving[f"{name} trunk tf32={'on' if tf32 else 'off'}"] = trunk_ms
            say(f"{name} sample_videos(64): {ms:.3f} ms, {64e3 / ms:.0f} clips/s; "
                f"trunk alone (1024 frames) {trunk_ms:.3f} ms ({tag}); {card}")

    record = {"kernels": [
        {"name": "rk4_motion", "route": "cuda",
         "source": "ganode_tpu_torch/csrc/motion_kernels.cu",
         "replaces": "ganode_tpu/ops/fused_rk4.py:106",
         "launches": launches_k1, "max_abs_err": errs["rk4"],
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None, "call_ms": k1_call_ms},
        {"name": "gru_motion", "route": "cuda",
         "source": "ganode_tpu_torch/csrc/motion_kernels.cu",
         "replaces": "ganode_tpu/ops/fused_gru.py:90",
         "launches": launches_k2, "max_abs_err": errs["gru"],
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms, "call_ms": k2_call_ms},
    ], "serving_ms": serving, "card": smi}
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
