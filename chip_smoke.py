#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``ganode_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``). In order, each phase
printing one line before the next starts:

1. arms a watchdog: a phase that hangs for 240 s dumps its traceback and
   exits non-zero;
2. prints the card's name and power limit (``nvidia-smi``), torch, CUDA and
   nvcc versions;
3. builds the kernels from ``ganode_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together, linked into one library), prints the
   seconds and what ``ptxas -v`` said of each kernel, and requires that the
   warp variants and K3's kernels (four tensor-core tiles, two bytes
   kernels) spill nothing;
4. holds every variant of K1 (fused RK4) and K2 (fused GRU) against its plain
   PyTorch version on the card: the warp variant at 16 lanes (serving, ragged
   and odd-B shapes) and at 32, the wide variant at a width above 32 and,
   forced, at the serving shape;
5. serves ``ucf_ode`` at full width through ``GeneratorSession``, shows K1's
   warp-variant counter rose, and holds the videos against the same noise
   decoded with the plain RK4 (and, for 2 clips, against the CPU);
6. the same for ``mnist_gru`` with K2;
7. times at the serving shape each kernel's warp variant and the wide one
   (the earlier shared-memory design) in turns (warp, wide, wide, warp), the
   wrapper call, the plain version, cuDNN's GRU as K2's yardstick, and
   ``sample_videos(64)`` for both configs, with CUDA events after warm-up;
8. trains ``ucf_ode`` at full width through ``build_trainer`` (B=32, T=16,
   64x64x3, ngf = ndf = 64, ``VideoDiscriminator(ksize=4)``, d_iters 2) on
   uniform random batches: 2 warm-up steps, then N timed steps with cuDNN's
   TF32 off and on, requiring K1's warp counter to rise by exactly 6 per step
   and finite losses; times each phase (D_img, D_vid, G update), the peak
   memory, and K1's backward (the plain recurrence's VJP) alone;
9. checks the G update on the card, on a freshly initialised full-width
   trainer and one noise tape: G's gradients through K1 against those through
   ``reference_rk4_motion`` given K1's forward values (the gradient path
   alone), and against those with the motion computed by
   ``reference_rk4_motion`` (beside the same update with that motion moved by
   1e-6, the change the kernel's float32 error is of);
10. takes one whole ``train_step`` at reduced width (ngf = ndf = 8, B = 4,
    T = 16) on the card and on the CPU in float64, from one state carried
    across after a CPU step and one noise tape, and holds the losses and every
    net's parameters and statistics together;
11. trains ``mnist_gru`` at full width for 2 steps, K2's counter +6 per step;
12. runs the training command line, ``python -m ganode_tpu_torch.train
    --config ucf_ode --synthetic --steps 4`` at full width (logging every
    step, samples and checkpoints every 2), and checks what it wrote: four
    finite ``metrics.jsonl`` lines, TensorBoard events (read back by the
    port's own reader), the GIFs of steps 0 and 2, checkpoints 0, 2 and 4;
    its child process starts together with phase 14's and phase 25's, and
    phase 14 runs right after it, before the timed phases from 13 on;
13. drives ``run_training`` on ``ucf_ode`` at full width in this process
    (its batches through ``data/loader.py::prefetch``, drawn ahead in a
    worker thread and copied from pinned memory on a side stream): K1's
    warp counter +6 per step exactly, ms/step from the runner's own log
    beside phase 8's bare ``train_step``, the host data path (gather and
    copy to the card) alone, the time the loop waited for each step's
    batches, and a checkpoint's size and save and restore times (the
    restore bit for bit);
14. in a child process under deterministic algorithms (cuDNN deterministic,
    ``torch.use_deterministic_algorithms``, ``CUBLAS_WORKSPACE_CONFIG`` set
    before cuBLAS starts): 4 ``ucf_ode`` steps straight, then 2 steps, a
    STOP file, and a resume to 4; every parameter, BatchNorm statistic and
    Adam moment must be equal bit for bit; on the python samplers, then
    through the native loader (``data_loader="native"``) over a pack of 32
    random uint8 videos of 40 frames written here, whose streams the resume
    opens at batch ``2 * d_iters``;
15. trains ``mnist_gru`` at full width through ``make_device_data_step``, its
    synthetic rotated-MNIST set resident on the card: K2 +6 per step;
16. trains ``ucf_wgan_gp_128`` at full width (dcgan128, ngf = ndf = 64,
    B=32, T=32, 128x128x3, spectral-norm critics, GP 10, d_iters 5, dopri5
    motion) on uniform random batches on the card, cuDNN TF32 on: 1 warm-up
    step, then 2 timed steps; ms/step, clips/s, ms per phase, peak memory,
    the step's FLOPs counted from the shapes (``step_flops``), per dopri5
    solve its evaluations, accepted and rejected steps, host syncs and ms;
    requires finite losses, K1 and K2 +0 (dopri5 runs no kernel, as in
    JAX), every critic's ``u`` advanced 2 * d_iters + 1 times per step and
    of norm 1 +- 1e-5, and no dopri5 interval out of steps;
17. takes one reduced-width ``ucf_wgan_gp_128`` step (ngf = ndf = 8, B = 4,
    T = 16, d_iters 2) on the card and on the CPU in float64, as phase 10:
    losses, parameters, ``u`` and Adam moments within 1e-4;
18. solves the dopri5 motion (B=32, T=32) and its adjoint gradient on the
    card and on the CPU in float64: the trajectory within the solver's
    tolerance, the gradients within 1e-4;
19. drives ``run_training`` on ``ucf_wgan_gp_128`` at full width for 2
    steps, as phase 13 (K1 +0);
20. trains ``ucf_ode`` at full width with ``compute_dtype="bfloat16"``: K1
    +6 per step, ms/step beside phase 8's float32 and the video
    discriminator's forward and backward alone in both dtypes.
21. for each of ``mnist_sde``, ``mnist_cde``, ``mnist_ode_rnn`` and
    ``mnist_moe_ode`` in turn, trains it at full width (mnist28, ngf = ndf =
    64, B=32, T=16, ``VideoDiscriminator(ksize=2)``, d_iters 2) on uniform
    random batches, cuDNN TF32 on: 2 warm-up steps, then 3 timed; ms/step,
    clips/s, ms per phase, peak memory; requires finite losses and K1 and
    K2 +0 (these motions run no kernel, as in JAX);
22. and then serves it: ``sample_videos(64)`` through ``GeneratorSession``
    (finite, of the configured shape, K1 and K2 +0; timed with TF32 off and
    on, the motion sampler alone), and 2 clips against the same noise
    decoded on the CPU, < 1e-4;
23. takes one reduced-width step (ngf = ndf = 8, B = 4, T = 16) of
    ``mnist_sde`` and of ``mnist_cde`` on the card and on the CPU in
    float64, as phase 10;
24. solves the SDE (B=32, dim 16, T=16, dt 2.5e-2: 45 substeps) with euler,
    milstein and reversible Heun on the card against the CPU in float64
    from the same ``x0`` and ``dW`` (< 1e-4), and holds the reversible
    adjoint's gradients (in ``x0`` and the fields' parameters, a cotangent
    at every output time) against autograd through reversible Heun on the
    card (< 1e-4 of each tensor's largest value), timing both;
25. runs ``python -m ganode_tpu_torch.train --config mnist_sde --synthetic
    --steps 2`` at full width (beside phase 12's child): two finite
    ``metrics.jsonl`` lines and a checkpoint of step 2;
26. holds DiffAugment (``train/diffaug.py``, plain tensor code: the JAX
    package's is plain ``jnp``, no kernel) on the card against the CPU given
    the same draws, each op and the whole policy ungated and with ADA gates
    at p 0, 0.5 and 1, at ``mnist_ode``'s video shape and
    ``ucf_wgan_gp_128``'s image shape: translation and cutout exact, the
    colour ops within 1e-6, p=1 the ungated result bit for bit, p=0 the
    identity; and times the whole policy on a ``ucf_wgan_gp_128`` video
    batch;
27. trains ``mnist_ode`` at full width with the options of the JAX
    package's ADA run (``DEMO_RESULTS_ADA.json``: ``diffaug=color,
    translation,cutout``, ``r1_weight=0.1``, ``ada_target=0.6``,
    ``ada_p_max=1.0``) and, in turns, without them: 2 warm-up + 3 timed
    steps each, cuDNN TF32 on; ms/step of both, ms per phase, peak memory,
    ``p_img`` and ``p_vid`` after each step; requires finite losses, p on
    the device within [0, p_max], and K1's launches per step equal to the
    unaugmented step's (6), K2 +0;
28. trains ``ucf_wgan_gp_128`` at full width with ``diffaug=color,
    translation,cutout`` (the JAX package's north-star run): 1 warm-up + 2
    timed steps, beside phase 16's unaugmented step; ms/step, ms per phase,
    peak memory; K1 and K2 +0;
29. takes one reduced-width ADA + R1 ``mnist_ode`` step (ngf = ndf = 8,
    B = 4, p carried in at 0.5 and 0.3) on the card and on the CPU in
    float64, as phase 10: losses, ``rt``, ``p``, parameters, statistics and
    Adam moments within 1e-4;
30. closes the loop on the card: trains 2 steps of the ADA config with EMA
    through ``python -m ganode_tpu_torch.train`` (a child process), serves
    its workdir through ``python -m ganode_tpu_torch.generate --workdir
    --out --gif`` (another), and holds the videos against
    ``GeneratorSession`` on ``eval_gen_variables`` of the restored state and
    the GIF, decoded by ``utils/gifs.read_gif``, against their grid;
31. times what the discriminators' ``leaky_relu`` with flax's derivative at
    0 (``nn/layers.py``) costs against ``F.leaky_relu``: the
    ``ucf_ode`` (TF32 on) and ``ucf_wgan_gp_128`` steps in turns (flax,
    fused, fused, flax) in this process, the warm-up before the first turn
    only;
32. for ``ucf_gres`` and then ``ucf_odegres`` (the GResBlock trunks,
    ``nn/gresblock.py``: plain ``F.conv2d``, as the JAX package's are plain
    XLA), trains at full width (B=32, T=16, 64x64x3, ngf = ndf = 64, SN
    critics, hinge, d_iters 2, rk4 motion), cuDNN TF32 on: 1 warm-up + 3
    timed steps; ms/step, ms per phase, peak memory, TFLOP per step counted
    from the shapes and TFLOP/s; requires finite losses, K1 +6 per step and
    K2 +0, the generator's blocks advancing their ``u`` (``u0``/``u1``)
    2 * d_iters + 2 times per step and each critic 2 * d_iters + 1, every
    ``u`` of norm 1 +- 1e-5 and moved;
33. takes one reduced-width step of it (ngf = ndf = 8, B = 4, T = 16,
    d_iters 2) on the card and on the CPU in float64, as phase 10, with the
    card in float64 (the plain motion): losses, parameters, statistics,
    ``u``/``u0``/``u1`` and Adam moments within 1e-4; and with the card in
    float32 against the same float64 step, by fixed bars per part of each
    net (``F32_RTOL``, ``F32_FLOOR``; the Adam moments and parameters more,
    for the ReLU inputs that change sign between float32 and float64 and
    Adam's steps on exactly-zero gradients: ``F32_MOMENTS``, 2 lr);
34. serves it at full width: ``sample_videos(64)`` through
    ``GeneratorSession`` (K1 +1, finite, in [-1, 1]), the videos against
    the same noise decoded with the plain rk4 motion, all 1,024 frames in
    one trunk call as the sampler decodes them (the ODE field normalises by
    the call's batch statistics) < 1e-4 with TF32 off; ms per call and the
    trunk alone with TF32 on, peak memory;
35. differentiates K1 and K2 twice (``d/dθ <VJP(g), v>``, the ODE-GAN
    regularizer's need) through their ``Function``s, each variant forced,
    against the plain recurrences at ``ucf_ode``'s and ``mnist_gru``'s
    motion shapes (B=32, D=16, T=16): within 1e-5 of each tensor's largest
    magnitude;
36. runs the ODE-GAN trainer (``train/odegan.py``) over the full-width
    ``ucf_ode`` triple (``make_mocogan_losses``: eval mode, BCE; lr 0.02,
    reg 0.01, cuDNN TF32 on): a ``dis_img``, ``dis_vid`` and ``gen`` step
    with each of euler, rk2 and rk4 on uniform random real batches, each
    moving only its own net, finite, with K1 launched once per sample (3, 3,
    2; 4, 4, 4; 6, 6, 8) and K2 never; then 3 timed rk4 triples after that
    warm-up: ms per network step, the regularizer alone, peak memory;
37. takes one reduced rk4 triple (ngf = ndf = 8, B = 4, T = 16) from one
    set of weights and running statistics and one noise dict, on the card in
    float64 (the plain motion) and in float32 (K1) against the CPU in
    float64: each net's parameters after each step and each D step's
    penalty gradient, float64 within 1e-4, float32 within phase 33's fixed
    bars per part;
38. runs ``python -m ganode_tpu_torch.train_odegan --synthetic`` in five
    child processes started together: ``--arch mlp`` with adam, euler, rk2 and rk4 (3 steps, B=64)
    and ``--arch dcgan --method euler --dry-run``; exit 0, the losses file
    in the JAX script's format, finite; ms per step.
39. evaluates at the north-star geometry (``eval/``: cuDNN convolutions
    and host numpy, as the JAX package's eval is plain XLA and numpy; the
    feature models are trained here, so no ``eval_assets/`` is needed): ``synthetic_moving_shapes(512, 32, size=128)`` moved to the card
    (3.2 GB), ``train_video_embedder`` (64 classes, 128 features, 20 steps,
    batch 16) and ``train_classifier`` (8 classes, 20 steps, one random
    frame per clip); their features of 8 clips and probabilities of 64
    frames against the CPU in float64 (TF32 off, cuDNN deterministic, <
    1e-4 of the largest magnitude); then scores a seeded full-width
    ``ucf_wgan_gp_128`` generator after one warm-up pass: 256 fakes from 4
    x ``sample_videos(64)``, embedded at batch 32 with 256 reals, FVD and
    IS finite, K1 and K2 +0 (dopri5, as in JAX); ms per 64-clip sample and
    per 32-clip embed, FVD ms, the whole eval's seconds and clips/s, peak
    memory;
40. runs ``python -m ganode_tpu_torch.evaluate --config ucf_ode --synthetic
    --n-samples 256 --classifier-steps 20`` in this process on a fresh
    2-step full-width run, twice on one assets directory: ``eval.json``
    with the JAX script's keys and finite scores, K1 +4 (one per 64-clip
    chunk) and K2 +0 each time, the assets trained and saved by the first
    run and loaded, their hashes unchanged, by the second;
41. requires warpgroup MMA (``GMMA``) in the SASS of K3's tensor-core
    kernel (``cuobjdump -sass``); holds K3 (``deconv_i8``, the int8
    transposed conv of ``csrc/int8_deconv.cu``) against its plain version
    (``F.conv_transpose2d`` in float64 on the card, rounded; the CPU's on 2
    frames) at every layer of the full-width int8 trunks of ``ucf_ode``,
    ``mnist_ode`` and ``ucf_wgan_gp_128`` at B' = 64 T frames and at the
    card tests' shapes that cross tile edges, random and +-127 codes (sums
    past 2^24), int32 and the fused float32 epilogue, all bit for bit;
    times each layer's K3, plain version, cuDNN's bf16 and TF32
    ``conv_transpose2d`` and ``torch._int_mm`` on the layer's dense GEMM
    (yardsticks; the port never calls them) beside the bound (int8
    operations at 1,979 TOPS, or bytes);
42. for each of those three configs, seeded weights with BatchNorm
    statistics from one train-mode pass: ``quantize_trunk``, static scales
    from ``calibrate_act_scales``, then ``generate.sample_videos_int8(64)``
    with dynamic and static scales: K3 +5 / +5 / +6 and K1 +1 / +1 / +0 per
    call (K2 +0), finite frames in [-1, 1]; the int8 frames against the
    float trunk's within JAX's bars (max 0.15, mean 0.02; static on fresh z
    0.2 / 0.02); the int8 state and every layer's codes equal to the CPU's
    plain int8 path on 2 clips, the frames within 1e-6; ms per
    ``sample_videos(64)`` float / int8 dynamic / int8 static and per trunk
    call, peak memory, weight bytes (the int8 state's tensors on the card,
    each layer's kernel once);
43. writes a synthetic full-width ``mnist_ode`` reference checkpoint (the
    chechaohp ``torch.save`` format, Adam moments included), runs ``python
    -m ganode_tpu_torch.import_reference`` and ``python -m
    ganode_tpu_torch.generate --workdir --int8 --gif`` in child processes:
    every imported weight, statistic and moment as written, the videos
    against the same sampling in this process, the GIF against its grid;
44. traces one int8 ``sample_videos(64)`` of ``ucf_ode`` with
    ``utils/profiling.trace`` under ``annotate``: the trace names the
    annotation, K3 and K1; the device's idle share between the call's
    first and last kernel;
45. (run right after phase 13) packs 32 uniform random uint8 videos of 40
    frames at 64x64x3 (~16 MB) into a temporary directory with the port's
    ``pack_arrays``, holds the first step's batches as ``prefetch`` puts
    them on the card against ``runtime.NativeClipLoader.next()``'s host
    batches of the same streams, bit for bit, and drives ``run_training``
    on ``ucf_ode`` through ``data_loader="native"`` (the C++ clip loader,
    built with ``g++``): K1 +6 per step exactly, finite losses, ms/step
    beside phase 13's python path and phase 8's bare step, the time the
    loop waited for each step's batches;
46. (run right after phase 19) the same for ``ucf_wgan_gp_128`` over 32
    videos of 48 frames at 128x128x3 (~75 MB), 2 steps, K1 +0;
47. writes 256 uniform random digits as MNIST's gzip idx files, runs
    ``python -m ganode_tpu_torch.build_rotmnist`` on them (in process) and
    ``run_training`` on ``mnist_ode`` at full width from the file, 2 steps
    (K1 6 per step, K2 0); samples a ``UCF101RandomClipSampler`` batch (15
    fps from a 30 fps ``pack_arrays`` pack) and applies the keyed
    transforms (flip, multi-scale corner and random crops, a temporal
    window, normalize) on the card and on the CPU with the same draws:
    within 1e-5, the flips exact;
48. the single-process references on the card, cuDNN deterministic and
    TF32 off: 2 ``run_training`` steps of ``ucf_ode`` at full width, one
    timed step, one ``mnist_moe_ode`` step, ``sample_videos(64)`` of
    ``ucf_ode`` in eval mode;
49. ``python -m torch.distributed.run --nproc-per-node 2 chip_smoke.py
    --mesh-child gloo``: two gloo ranks on the one card (point-to-point
    messages through pinned host memory) run ``run_training`` on ``ucf_ode`` with
    ``mesh="data=2"`` (2 steps, B=32 as 16 per rank): after the first
    step, against phase 48's, the losses within a relative 1e-3, every
    parameter within 4.2 lr (Adam's two updates, flipped), half of them
    within 0.01 lr, the BatchNorm statistics within 1e-2 of their largest; both
    ranks' states and losses equal bit for bit, K1 6 per step per rank; a timed N-way step (ms per rank, bytes and all-reduces per
    step); one expert-parallel ``mnist_moe_ode`` step on (data=1,
    expert=2) against phase 48's; a 2-stage ``pipelined_sample_videos(64)``
    against ``sample_videos`` within 1e-4 (K1 once per rank);
50. in this process, an NCCL group of one (``init_process_group`` at
    ``tcp://localhost`` on a free port): the same ``run_training`` with
    ``mesh="data=1"`` against phase 48's, K1 6 per step, and a timed step;
    the group is destroyed after.

Float32, except phase 20; each of phases 21-50 prints its seconds. Matrix
products run in full float32 (``torch.backends.cuda.matmul.allow_tf32 =
False``); the correctness checks also turn TF32 off for cuDNN's
convolutions, and the serving and training times are taken with cuDNN's
TF32 on (PyTorch's default), for ``ucf_ode`` also off.

The last two lines of standard output are one JSON object with a record per
kernel and the training run, and ``{"ok": true, "device": {...}}``. Any
failure exits non-zero before those lines. Writes nothing but
``ganode_tpu_torch/_build/`` and temporary directories that it deletes.

    python3 chip_smoke.py --resume-check DIR

is phase 14's child process: it trains in DIR and prints one JSON line;
``chip_smoke.py --mesh-child gloo DIR``, run by ``torch.distributed.run``,
is phase 49's ranks.
"""
from __future__ import annotations

import atexit
import copy
import faulthandler
import functools
import importlib.metadata
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# G's gradients through K1, each tensor's max abs difference over its max abs
# value, against the plain recurrence given K1's forward values (so only the
# gradient path differs; cuDNN deterministic, TF32 off).
TOL_GRAD = 1e-4
# Against the plain motion itself the forward values differ by ~1e-6, and at
# full width G's gradients move by ~1e-3 of their size for a change of that
# order, whatever computes it. So that comparison is held to YARDSTICKS times
# what the same update gives for the plain motion moved by PERTURB.
PERTURB = 1e-6
YARDSTICKS = 3.0
# One train_step, card against CPU: losses, parameters and statistics after
# conv stacks summed in another order on each device, and one Adam step.
TOL_STEP = 1e-4
TRAIN_STEPS = 5   # timed full-width steps per TF32 setting
RUNNER_STEPS = 6  # run_training steps; ms/step from the log of the first and last
DEVICE_DATA_STEPS = 3
# ucf_wgan_gp_128 (phases 16-19): timed full-width steps after one warm-up,
# run_training steps, and the dopri5 solves timed alone
WGAN_STEPS = 2
WGAN_RUNNER_STEPS = 2
# the SDE, CDE, ODE-RNN and MoE-ODE configs (phase 21): timed full-width
# steps after two warm-up steps
VARIANT_STEPS = 3
# DiffAugment and ADA (phases 26-30): the JAX package's documented options,
# timed steps after 2 (mnist_ode) and 1 (ucf_wgan_gp_128) warm-up steps; the
# card against the CPU for the colour ops (float32, another summation order
# in the means)
DIFFAUG = "color,translation,cutout"
ADA_RUN = {"diffaug": DIFFAUG, "r1_weight": 0.1, "ada_target": 0.6,
           "ada_p_max": 1.0}
DIFFAUG_STEPS = 3
WGAN_DIFFAUG_STEPS = 2  # ucf_wgan_gp_128 + diffaug (phase 28)
TOL_COLOR = 1e-6
# Videos the generate CLI served against the same sampling in this process:
# the same ops on the same card, cuDNN choosing its algorithms per process.
TOL_CROSS_PROCESS = 1e-6
# A spectral-norm critic's u is a unit vector: after a step, its norm within
# this of 1 (float32 power iteration).
TOL_U_NORM = 1e-5
# dopri5 on the card against the CPU in float64: the trajectories within the
# solver's own tolerance, atol + rtol |y|; the adjoint's gradients, each
# tensor's max |diff| over its max |value|, within 10 rtol.
TOL_DOPRI_GRAD = 1e-4
FRAME_SIZE = {"mnist28": 28, "dcgan64": 64, "dcgan128": 128, "gres64": 64,
              "odegres64": 64}
REPO = os.path.dirname(os.path.abspath(__file__))
# Deterministic cuBLAS: must be in the environment before cuBLAS starts.
CUBLAS_DETERMINISTIC = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


_T0 = time.perf_counter()


def phase(name: str):
    """Arm the watchdog and print the phase's line, with the seconds since
    the script started."""
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    print(f"== [{time.perf_counter() - _T0:.1f} s] {name}", flush=True)


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


def reset_counts():
    from ganode_tpu_torch.ops import fused_gru, fused_rk4, quant

    for m in (fused_rk4, fused_gru):
        m.launches = 0
        m.launches_by_variant.update(warp=0, wide=0)
    quant.launches = 0


def events_ms(fn, n):
    """Mean ms per call between CUDA events around n calls: what a caller
    sees, host overhead included when the card outpaces the host."""
    import torch

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


def device_ms(fn, n, with_host=False):
    """Mean device ms per call: the calls are queued behind a spin kernel
    that outlasts their enqueue, so the events see back-to-back work. With
    ``with_host``, (device ms, the host's µs per call while the card is
    busy)."""
    import torch

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
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / n
    return (ms, host_s / n * 1e6) if with_host else ms


def in_turns(new, old, n):
    """Device ms of two versions timed new, old, old, new: the means of
    each side and the four readings in order."""
    runs = [device_ms(fn, n) for fn in (new, old, old, new)]
    return (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2, runs


def random_batches(cfg, device, seed):
    """Uniform [-1, 1) images ``(d_iters, B, S, S, C)`` and videos
    ``(d_iters, B, T, S, S, C)``, as ``bench.py`` feeds its step."""
    import torch

    size = FRAME_SIZE[cfg.trunk]
    g = torch.Generator(device).manual_seed(seed)
    shape = (cfg.d_iters, cfg.batch_size)
    images = torch.rand(shape + (size, size, cfg.n_channels), generator=g,
                        device=device) * 2 - 1
    videos = torch.rand(shape + (cfg.video_length, size, size,
                                 cfg.n_channels), generator=g,
                        device=device) * 2 - 1
    return images, videos


def phase_ms(tr, state, images, videos, generator, n):
    """ms per step of each phase of ``tr``'s step (D_img, D_vid summed over
    the D iterations, each with its penalty pass; G), between CUDA events on
    the step's stream, over ``n`` steps."""
    import torch

    d = tr.d_iters
    tot = {"d_img": 0.0, "d_vid": 0.0, "g": 0.0}
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * d + 2)]
        ev[0].record()
        ada = state.ada or {}
        for i in range(d):
            tr._d_phase(state, "image", images[i], {}, generator,
                        ada.get("p_img"))
            ev[2 * i + 1].record()
            tr._d_phase(state, "video", videos[i], {}, generator,
                        ada.get("p_vid"))
            ev[2 * i + 2].record()
        tr._g_update(state, {}, {}, generator)
        ev[-1].record()
        torch.cuda.synchronize()
        for i in range(d):
            tot["d_img"] += ev[2 * i].elapsed_time(ev[2 * i + 1])
            tot["d_vid"] += ev[2 * i + 1].elapsed_time(ev[2 * i + 2])
        tot["g"] += ev[-2].elapsed_time(ev[-1])
    return {k: v / n for k, v in tot.items()}


def backward_ms(module, motion_args, events_ms):
    """ms per call of one kernel's backward alone (``_Fused*.backward``: the
    plain recurrence re-run and differentiated), at the training shape."""
    import torch

    leaves = [a.detach().clone().requires_grad_() for a in motion_args[0]]
    out = module(*leaves, *motion_args[1])
    g = torch.randn_like(out)
    return events_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                 retain_graph=True), 10)


def cast_noise(noise: dict, dtype) -> dict:
    """A noise dict with its float tensors (the augmentation's draws, nested,
    too) in ``dtype``."""
    return {k: cast_noise(v, dtype) if isinstance(v, dict) else
            v.to(dtype) if v.is_floating_point() else v
            for k, v in noise.items()}


def card_vs_cpu_step(dev, cfg_r, ada=None, card_dtype=None, detail=False):
    """One ``train_step`` of the reduced-width config ``cfg_r`` from one
    state and one noise tape, on the card in float32 and on the CPU in
    float64 (the plain motion) and in float32 -> (the card's max |loss diff|
    (and ADA metrics') and max |diff| over every net's parameters,
    statistics (BatchNorm's, spectral norm's ``u``) and Adam moments from
    float64, the same two for the CPU's float32, tensors compared). ``ada``
    sets the carried state's ADA probabilities; ``card_dtype=torch.float64``
    runs the card's step in float64 (the plain motion, as the CPU's);
    ``detail`` also returns the card's and the float64 reference's tensors
    by name (``"<net>.<buffer or parameter>"``, ``"<net>.adam.<parameter>.
    exp_avg"``...).

    The state is carried across after one CPU step: Adam's first step from
    zero moments is lr * sign(g), which turns the rounding of a near-zero
    gradient into a 2 * lr difference. The reference is float64 because a
    float32 CPU step is no closer to it than the card's: with torch 2.11 on
    the H100 host's CPU, oneDNN's float32 path has left G's gradients further
    from their float64 values than the card's (PERF.md §6)."""
    import torch

    import ganode_tpu_torch.models.motion as motion_mod
    from ganode_tpu_torch.ops import fused_rk4_motion, reference_rk4_motion
    from ganode_tpu_torch.train import build_trainer
    from ganode_tpu_torch.utils.config import get_config

    ims, vids = random_batches(cfg_r, "cpu", 7)
    tr_c = build_trainer(cfg_r, device="cpu")
    st_c = tr_c.init_state()
    tr_c.train_step(st_c, ims, vids, noise=tr_c.noise_tape(
        torch.Generator().manual_seed(1), "cpu"))
    nets = ("gen", "dis_img", "dis_vid")

    def take_step(device, dtype):
        tr = build_trainer(cfg_r, device=device)
        st = tr.init_state()
        for n in nets:
            getattr(tr, n).to(dtype=dtype).load_state_dict(
                getattr(tr_c, n).state_dict())
            getattr(st, n).opt.load_state_dict(
                copy.deepcopy(getattr(st_c, n).opt.state_dict()))
        st.step = st_c.step
        if ada is not None:
            st.ada = {k: torch.tensor(v, device=device) for k, v in ada.items()}
        tape = [cast_noise(d, dtype)
                for d in tr.noise_tape(torch.Generator().manual_seed(7), device)]
        metrics = tr.train_step(st, ims.to(device, dtype),
                                vids.to(device, dtype), noise=tape)
        out = {f"{n}.{k}": v.detach().cpu().double()
               for n in nets for k, v in getattr(tr, n).state_dict().items()}
        for n in nets:
            names = {p: k for k, p in getattr(tr, n).named_parameters()}
            for p, a in getattr(st, n).opt.state.items():
                for m in ("exp_avg", "exp_avg_sq"):
                    out[f"{n}.adam.{names[p]}.{m}"] = a[m].cpu().double()
        return {k: v.item() for k, v in metrics.items()}, out

    card_dtype = card_dtype or torch.float32
    if card_dtype == torch.float32:
        m_card, s_card = take_step(dev, card_dtype)
    m_cpu, s_cpu = take_step("cpu", torch.float32)
    motion_mod.fused_rk4_motion = reference_rk4_motion  # float32 only
    try:
        m_ref, s_ref = take_step("cpu", torch.float64)
        if card_dtype == torch.float64:
            m_card, s_card = take_step(dev, card_dtype)
    finally:
        motion_mod.fused_rk4_motion = fused_rk4_motion

    def errs(m, sd):
        return (max(abs(m[k] - m_ref[k]) for k in m_ref),
                max((sd[k] - v).abs().max().item() for k, v in s_ref.items()))

    out = (*errs(m_card, s_card), *errs(m_cpu, s_cpu), len(s_ref))
    return (*out, s_card, s_ref) if detail else out


def train_phases(dev, card, events_ms) -> dict:
    """Phases 8-11 (module docstring); returns the record's training entry."""
    import torch

    import ganode_tpu_torch.models.motion as motion_mod
    from ganode_tpu_torch.ops import (fused_gru, fused_gru_motion, fused_rk4,
                                      fused_rk4_motion, reference_rk4_motion)
    from ganode_tpu_torch.train import build_trainer
    from ganode_tpu_torch.utils.config import get_config

    out = {}
    phase("train ucf_ode at full width (B=32, T=16, 64x64x3, ngf=ndf=64, "
          "VideoDiscriminator ksize 4, d_iters 2)")
    cfg = get_config("ucf_ode")
    tr = build_trainer(cfg, device=dev)
    state = tr.init_state()
    gt = torch.Generator(dev).manual_seed(0)
    images, videos = random_batches(cfg, dev, 0)
    rec = {"config": "ucf_ode", "batch": cfg.batch_size, "frames": cfg.video_length,
           "d_iters": cfg.d_iters, "card": card}

    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        tag = "on" if tf32 else "off"
        for _ in range(2):
            tr.train_step(state, images, videos, generator=gt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(TRAIN_STEPS):
            metrics = tr.train_step(state, images, videos, generator=gt)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / TRAIN_STEPS
        by_variant = dict(fused_rk4.launches_by_variant)
        rec["k1_launches_per_step"] = fused_rk4.launches / TRAIN_STEPS
        say(f"ucf_ode train_step: K1 launches {by_variant} in {TRAIN_STEPS} "
            f"steps, K2 {fused_gru.launches}")
        require(by_variant == {"warp": 6 * TRAIN_STEPS, "wide": 0}
                and fused_gru.launches == 0,
                f"K1 did not launch exactly 6 times per step: {by_variant}")
        losses = {k: v.item() for k, v in metrics.items()}
        require(all(map(math.isfinite, losses.values())),
                f"non-finite losses {losses}")
        mem = torch.cuda.max_memory_allocated()
        phases = phase_ms(tr, state, images, videos, gt, 3)
        say(f"ucf_ode train_step (cuDNN TF32 {tag}): {ms:.3f} ms/step, "
            f"{cfg.batch_size * 1e3 / ms:.1f} clips/s; phases per step: "
            f"D_img {phases['d_img']:.3f} ms, D_vid {phases['d_vid']:.3f} ms, "
            f"G {phases['g']:.3f} ms; peak memory "
            f"{mem / 2 ** 30:.2f} GiB; losses {losses}; {card}")
        rec[f"tf32_{tag}"] = {"ms_per_step": ms,
                              "clips_per_s": cfg.batch_size * 1e3 / ms,
                              "phase_ms": phases, "max_memory_bytes": mem,
                              "losses": losses}

    m = tr.gen.motion
    l0, l1 = m.ode_fn.Dense_0, m.ode_fn.Dense_1
    with torch.no_grad():
        x = m.WarmupMLP_0(torch.randn((cfg.batch_size, cfg.dim_z_motion),
                                      generator=gt, device=dev))
    k1_args = ((x, l0.weight.t().contiguous(), l0.bias,
                l1.weight.t().contiguous(), l1.bias),
               (torch.linspace(0.0, 1.0, cfg.video_length),))
    rec["k1_backward_ms"] = backward_ms(fused_rk4_motion, k1_args, events_ms)
    share = {tag: 2 * rec["k1_backward_ms"] / rec[f"tf32_{tag}"]["ms_per_step"]
             for tag in ("off", "on")}
    rec["k1_backward_share"] = share
    say(f"K1 backward (plain rk4 VJP, B={cfg.batch_size}): "
        f"{rec['k1_backward_ms']:.3f} ms per call; two per step = "
        f"{100 * share['off']:.1f} % of a TF32-off step, "
        f"{100 * share['on']:.1f} % of a TF32-on step; {card}")

    phase("G update on the card: K1 against the plain recurrence")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    tr0 = build_trainer(cfg, device=dev)
    st0 = tr0.init_state()
    noise_vid, noise_img = tr0.noise_tape(torch.Generator().manual_seed(5),
                                          dev)[-2:]

    def g_grads(motion):
        motion_mod.fused_rk4_motion = motion
        try:
            return tr0._g_grads(st0, noise_vid, noise_img, None)
        finally:
            motion_mod.fused_rk4_motion = fused_rk4_motion

    def kernel_values(*args):
        """The kernel's forward values, the plain recurrence's gradient."""
        plain = reference_rk4_motion(*args)
        with torch.no_grad():
            kernel = fused_rk4_motion(*args)
        return plain + (kernel - plain).detach()

    def perturbed(*args):
        """The plain motion moved by PERTURB relative, about the kernel's own
        forward error (TOL_TRAJ)."""
        out = reference_rk4_motion(*args)
        g = torch.Generator().manual_seed(9)
        return out * (1 + PERTURB * torch.randn(out.shape, generator=g).to(dev))

    def worst(a, b):
        return max(((x - y).abs().max() / y.abs().max()).item()
                   for x, y in zip(a, b))

    before = fused_rk4.launches
    loss_k, grads_k = g_grads(fused_rk4_motion)
    loss_s, grads_s = g_grads(kernel_values)
    loss_p, grads_p = g_grads(reference_rk4_motion)
    loss_q, grads_q = g_grads(perturbed)
    torch.backends.cudnn.deterministic = False
    require(fused_rk4.launches == before + 4,
            f"the G updates launched K1 {fused_rk4.launches - before} times, "
            "not 2 + 2")
    rel_wiring = worst(grads_k, grads_s)
    rel_plain, yardstick = worst(grads_k, grads_p), worst(grads_q, grads_p)
    say(f"G update at init, {len(grads_k)} tensors, worst max|diff|/max|ref| "
        f"(cuDNN deterministic, TF32 off): through K1 vs the plain recurrence "
        f"fed K1's forward values {rel_wiring:.3e} (tol {TOL_GRAD}), |loss "
        f"diff| {abs(loss_k.item() - loss_s.item()):.3e}; through K1 vs the "
        f"plain motion {rel_plain:.3e}, against {yardstick:.3e} for the plain "
        f"motion moved by {PERTURB:g} (tol {YARDSTICKS} x that), |loss diff| "
        f"{abs(loss_k.item() - loss_p.item()):.3e}")
    require(rel_wiring < TOL_GRAD and abs(loss_k.item() - loss_s.item()) < TOL_GRAD,
            f"K1's gradient path: {rel_wiring}")
    require(rel_plain <= YARDSTICKS * yardstick,
            f"K1 vs plain motion {rel_plain} > {YARDSTICKS} x {yardstick}")
    rec["g_grad_rel_err"] = {"kernel_vs_plain_backward": rel_wiring,
                             "kernel_vs_plain_motion": rel_plain,
                             "plain_motion_perturbed": yardstick}
    del tr0, st0, grads_k, grads_s, grads_p, grads_q

    phase("one train_step at reduced width (ngf=ndf=8, B=4, T=16): card vs CPU")
    torch.backends.cudnn.deterministic = True
    err_loss, err_nets, cpu_loss, cpu_nets, n_tensors = card_vs_cpu_step(
        dev, get_config("ucf_ode", ngf=8, ndf=8, batch_size=4))
    torch.backends.cudnn.deterministic = False
    say(f"train_step vs the CPU's float64 step: card (float32, TF32 off, cuDNN "
        f"deterministic) "
        f"losses max|diff| {err_loss:.3e}, parameters and statistics "
        f"and Adam moments max|diff| {err_nets:.3e} over {n_tensors} tensors "
        f"(tol {TOL_STEP}); "
        f"the CPU's float32 step {cpu_loss:.3e} and {cpu_nets:.3e}")
    require(err_loss < TOL_STEP and err_nets < TOL_STEP,
            f"card vs CPU: losses {err_loss}, nets {err_nets}")
    rec["card_vs_cpu_max_abs"] = {"losses": err_loss, "nets": err_nets,
                                  "cpu_float32_losses": cpu_loss,
                                  "cpu_float32_nets": cpu_nets}
    out["ucf_ode"] = rec

    phase("train mnist_gru at full width (B=32, T=16, 28x28x1, ngf=ndf=64, "
          "ksize 2): 2 steps")
    torch.backends.cudnn.allow_tf32 = True
    cfg_g = get_config("mnist_gru")
    trg = build_trainer(cfg_g, device=dev)
    stg = trg.init_state()
    images_g, videos_g = random_batches(cfg_g, dev, 1)
    reset_counts()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(2):
        metrics = trg.train_step(stg, images_g, videos_g, generator=gt)
    b.record()
    torch.cuda.synchronize()
    by_variant = dict(fused_gru.launches_by_variant)
    k2_per_step = fused_gru.launches / 2
    losses = {k: v.item() for k, v in metrics.items()}
    say(f"mnist_gru train_step: K2 launches {by_variant} in 2 steps, K1 "
        f"{fused_rk4.launches}; {a.elapsed_time(b) / 2:.3f} ms/step over the "
        f"first two (cuDNN TF32 on, no warm-up); losses {losses}; {card}")
    require(by_variant == {"warp": 12, "wide": 0} and fused_rk4.launches == 0,
            f"K2 did not launch exactly 6 times per step: {by_variant}")
    require(all(map(math.isfinite, losses.values())), f"losses {losses}")
    c = trg.gen.motion.gru
    k2_args = ((torch.randn((cfg_g.batch_size, 16), generator=gt, device=dev),
                torch.randn((16, cfg_g.batch_size, 16), generator=gt, device=dev),
                c.wi, c.wh, c.bi, c.bh), ())
    k2_bwd = backward_ms(fused_gru_motion, k2_args, events_ms)
    say(f"K2 backward (plain GRU VJP, B={cfg_g.batch_size}): {k2_bwd:.3f} ms "
        f"per call; {card}")
    out["mnist_gru"] = {"ms_per_step_first_two": a.elapsed_time(b) / 2,
                        "losses": losses, "k2_launches_per_step": k2_per_step,
                        "k2_backward_ms": k2_bwd}
    return out


def run_child(cmd, what, env=None):
    """Run a child process to its end (inside the phase's watchdog) ->
    its standard output; fails with the end of its output if it fails."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                             env={**os.environ, **(env or {})},
                             timeout=WATCHDOG_S - 30)
    except subprocess.TimeoutExpired:
        raise SystemExit(f"FAIL: {what} did not finish in {WATCHDOG_S - 30} s")
    if out.returncode != 0:
        say(out.stdout[-3000:])
        say(out.stderr[-6000:])
    require(out.returncode == 0, f"{what} exited {out.returncode}")
    return out.stdout


_STARTED: dict = {}


def _stop_started():
    for p, _, _ in _STARTED.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def start_child(key: str, cmd, what, env=None):
    """Start a child process now, to be waited for by ``wait_child(key)``
    in a later phase: the child-process gates of phases 12, 14 and 25 run
    together, before the timed phases 13 on. A run that ends early kills
    the children it left."""
    if not _STARTED:
        atexit.register(_stop_started)
    _STARTED[key] = (subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env={**os.environ, **(env or {})}), what,
        time.perf_counter())


def wait_child(key: str):
    """-> (the started child's standard output, seconds since its start);
    fails with the end of its output if it fails."""
    p, what, t0 = _STARTED.pop(key)
    try:
        stdout, stderr = p.communicate(timeout=WATCHDOG_S - 30)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        raise SystemExit(f"FAIL: {what} did not finish in {WATCHDOG_S - 30} s")
    if p.returncode != 0:
        say(stdout[-3000:])
        say(stderr[-6000:])
    require(p.returncode == 0, f"{what} exited {p.returncode}")
    return stdout, time.perf_counter() - t0


def run_children(runs):
    """Start child processes ``[(cmd, what), ...]`` at once and wait for
    each (inside the phase's watchdog) -> ``[(stdout, seconds from the
    start), ...]``; fails with the end of a failed child's output. Every
    child is killed if one fails."""
    t0 = time.perf_counter()
    procs = [(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True, cwd=REPO),
              what) for cmd, what in runs]
    done = []
    try:
        for p, what in procs:
            left = WATCHDOG_S - 30 - (time.perf_counter() - t0)
            try:
                stdout, stderr = p.communicate(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                raise SystemExit(f"FAIL: {what} did not finish in "
                                 f"{WATCHDOG_S - 30} s")
            if p.returncode != 0:
                say(stdout[-3000:])
                say(stderr[-6000:])
            require(p.returncode == 0, f"{what} exited {p.returncode}")
            done.append((stdout, time.perf_counter() - t0))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return done


def jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def cli_phase(card, resume_dir, sde_dir) -> dict:
    """Phase 12: the training command line at full ucf_ode width, started
    together with phase 14's resume check (in ``resume_dir``) and phase
    25's mnist_sde command line (in ``sde_dir``)."""
    from ganode_tpu_torch.utils import tb

    phase("the training CLI: python -m ganode_tpu_torch.train --config "
          "ucf_ode --synthetic --steps 4 (full width), started together with "
          "phase 14's resume check and phase 25's mnist_sde command line")
    start_child("resume", [sys.executable, os.path.abspath(__file__),
                           "--resume-check", resume_dir], "the resume check",
                env=CUBLAS_DETERMINISTIC)
    start_child("sde_cli", [sys.executable, "-m", "ganode_tpu_torch.train",
                            "--config", "mnist_sde", "--synthetic", "--steps",
                            "2", "--workdir", os.path.join(sde_dir, "run"),
                            "--set", "log_every=1"],
                "the mnist_sde training CLI")
    tmp = tempfile.mkdtemp(prefix="ganode_cli_")
    try:
        wd = os.path.join(tmp, "run")
        start_child("cli", [sys.executable, "-m", "ganode_tpu_torch.train",
                            "--config", "ucf_ode", "--synthetic", "--steps",
                            "4", "--workdir", wd, "--set", "log_every=1",
                            "--set", "sample_every=2", "--set",
                            "checkpoint_every=2"], "the training CLI")
        _, seconds = wait_child("cli")
        lines = jsonl(os.path.join(wd, "metrics.jsonl"))
        losses = [{k: l[k] for k in ("dis_img_loss", "dis_vid_loss", "gen_loss")}
                  for l in lines]
        require([l["step"] for l in lines] == [0, 1, 2, 3]
                and all(math.isfinite(v) for d in losses for v in d.values()),
                f"metrics.jsonl: {lines}")
        gif_sizes = {}
        for step in (0, 2):
            path = os.path.join(wd, "samples", f"gensamples_id{step}.gif")
            require(os.path.exists(path), f"no {path}")
            with open(path, "rb") as f:
                data = f.read()
            # 16 frames of an 8x8 grid of 64x64 clips, ~9/8 bytes per pixel
            require(data[:6] == b"GIF89a" and data[-1:] == b";"
                    and len(data) > 16 * 512 * 512, f"{path}: not a GIF")
            gif_sizes[step] = len(data)
        ckpts = sorted(int(d) for d in os.listdir(os.path.join(wd, "checkpoints")))
        require(ckpts == [0, 2, 4], f"checkpoint steps {ckpts}")
        (events,) = os.listdir(os.path.join(wd, "tb"))
        version, scalars = tb.read_scalars(os.path.join(wd, "tb", events))
        require(version == "brain.Event:2" and [s for s, _ in scalars] == [0, 1, 2, 3]
                and all(math.isfinite(v) for _, d in scalars for v in d.values()),
                f"TensorBoard events {version} {scalars}")
        ckpt_bytes = os.path.getsize(os.path.join(wd, "checkpoints", "4", "state.pt"))
        say(f"CLI: 4 steps in {seconds:.1f} s of process, beside two others "
            f"(start, kernel load, "
            f"trainer, 4 steps, 2 GIFs of {gif_sizes} bytes, 3 checkpoints of "
            f"{ckpt_bytes / 2 ** 20:.1f} MiB); losses {losses}; TensorBoard "
            f"events read back: {len(scalars)}; {card}")
        return {"seconds": seconds, "losses": losses, "gif_bytes": gif_sizes,
                "checkpoint_bytes": ckpt_bytes}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def same_state(a, b):
    """Two port states, tensor by tensor -> (the number compared, the names
    of those not equal bit for bit): every module's parameters and
    statistics, every Adam moment and step count, the step."""
    import torch

    n, bad = 1, [] if a.step == b.step else ["step"]
    for name in ("gen", "dis_img", "dis_vid"):
        na, nb = getattr(a, name), getattr(b, name)
        sa = na.module.state_dict()
        for k, v in nb.module.state_dict().items():
            n += 1
            if not torch.equal(sa[k], v):
                bad.append(f"{name}.{k}")
        for (k, pa), pb in zip(na.module.named_parameters(),
                               nb.module.parameters()):
            for m in ("exp_avg", "exp_avg_sq", "step"):
                n += 1
                if not torch.equal(na.opt.state[pa][m], nb.opt.state[pb][m]):
                    bad.append(f"{name}.adam.{k}.{m}")
    return n, bad


# Native-loader phases (45, 46, and phase 14's child): synthetic uint8
# videos packed with the port's pack_arrays, (videos, frames each) per
# config; ~16 MB at 64x64x3 and ~75 MB at 128x128x3
NATIVE_PACKS = {"ucf_ode": (32, 40), "ucf_wgan_gp_128": (32, 48)}


def write_native_pack(cfg, directory, seed=0) -> str:
    """A pack of uniform random uint8 videos at ``cfg``'s frame geometry."""
    import numpy as np

    from ganode_tpu_torch.data import pack_arrays

    n, frames = NATIVE_PACKS[cfg.name]
    size = FRAME_SIZE[cfg.trunk]
    rng = np.random.default_rng(seed)
    videos = [rng.integers(0, 256, (frames, size, size, cfg.n_channels),
                           dtype=np.uint8) for _ in range(n)]
    return pack_arrays(directory, videos, rng.integers(0, 101, n).tolist(),
                       image_size=size, n_frame=cfg.video_length)


def timing_prefetch(runner, waits):
    """Put a wrapper around ``runner.prefetch`` that appends to ``waits``
    the seconds the loop waited for each step's batches -> a function that
    takes it off again."""
    orig = runner.prefetch

    def timed(*a, **kw):
        it = orig(*a, **kw)

        def gen():
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    waits.append(time.perf_counter() - t0)
                    yield item
            finally:
                it.close()

        return gen()

    runner.prefetch = timed
    return lambda: setattr(runner, "prefetch", orig)


def native_first_batch(dev, cfg) -> dict:
    """The first step's batches as prefetch puts them on the card, against
    NativeClipLoader.next()'s host batches of the same streams: bit for
    bit."""
    import torch

    from ganode_tpu_torch.data import prefetch
    from ganode_tpu_torch.runtime import NativeClipLoader
    from ganode_tpu_torch.train import runner

    samplers = runner.build_data(cfg)
    it = prefetch(runner.step_batches(*samplers, cfg, 0, 1), device=dev)
    try:
        images, videos = next(it)
        torch.cuda.synchronize()
    finally:
        it.close()
        for s in samplers:
            s.close()
    threads = cfg.data_loader_threads
    streams = ((images, 1, max(1, threads // 2), cfg.seed + 1),
               (videos, cfg.video_length, threads, cfg.seed))
    bad, n = [], 0
    for got, frames, n_threads, seed in streams:
        loader = NativeClipLoader(cfg.data_path, cfg.batch_size,
                                  n_frame=frames, n_threads=n_threads,
                                  seed=seed)
        try:
            for i in range(cfg.d_iters):
                want = torch.from_numpy(loader.next()[0])
                if frames == 1:
                    want = want[:, 0]
                n += 1
                if not (got.device.type == dev.type
                        and torch.equal(got[i].cpu(), want)):
                    bad.append(f"seed {seed} batch {i}")
        finally:
            loader.close()
    return {"batches": n, "mismatched": bad,
            "bytes": images.nbytes + videos.nbytes}


def runner_phase(dev, card, name, steps, bare_ms, k1_per_step,
                 python_path=None) -> dict:
    """Phases 13 and 19: run_training in process at full width of config
    ``name`` for ``steps`` steps on the python samplers, K1 launching
    ``k1_per_step`` times per step exactly; with ``python_path`` (that
    phase's record), phases 45 and 46: the same through the native loader
    over a pack written here, its first batch held against the loader's."""
    import torch

    from ganode_tpu_torch.ops import fused_gru, fused_rk4
    from ganode_tpu_torch.train import runner
    from ganode_tpu_torch.utils.checkpoint import CheckpointManager
    from ganode_tpu_torch.utils.config import get_config

    native = python_path is not None
    t_phase = time.perf_counter()
    phase(f"run_training on {name} at full width: {steps} steps, cuDNN TF32 "
          "on, " + ("through the native loader (data_loader=native, "
                    f"{NATIVE_PACKS[name][0]} packed videos of "
                    f"{NATIVE_PACKS[name][1]} frames)" if native
                    else "the python samplers"))
    torch.backends.cudnn.allow_tf32 = True
    cfg = get_config(name, log_every=steps - 1, sample_every=0,
                     checkpoint_every=0)
    tmp = tempfile.mkdtemp(prefix="ganode_runner_")
    waits = []
    try:
        out = {}
        if native:
            import dataclasses

            t0 = time.perf_counter()
            cfg = dataclasses.replace(cfg, data_loader="native",
                                      data_path=write_native_pack(
                                          cfg, os.path.join(tmp, "pack")))
            pack_s = time.perf_counter() - t0
            first = native_first_batch(dev, cfg)
            say(f"native first batch: {first['batches']} batches of the "
                f"image and clip streams ({first['bytes'] / 1e6:.1f} MB) as "
                f"prefetch put them on the card, {len(first['mismatched'])} "
                f"differ bit for bit from NativeClipLoader.next(); pack "
                f"written in {pack_s:.1f} s; {card}")
            require(first["batches"] == 2 * cfg.d_iters
                    and not first["mismatched"],
                    f"the card's first native batch differs from the "
                    f"loader's: {first['mismatched']}")
            out["first_batch"] = first
        wd = os.path.join(tmp, "run")
        untime = timing_prefetch(runner, waits)
        try:
            reset_counts()
            state, metrics = runner.run_training(cfg, wd, steps=steps,
                                                 synthetic=not native,
                                                 device=dev)
            torch.cuda.synchronize()
        finally:
            untime()
        by_variant = dict(fused_rk4.launches_by_variant)
        launches = fused_rk4.launches
        say(f"run_training {name}: K1 launches {by_variant} in {steps} steps, "
            f"K2 {fused_gru.launches}")
        require(by_variant == {"warp": k1_per_step * steps, "wide": 0}
                and fused_gru.launches == 0,
                f"K1 did not launch exactly {k1_per_step} times per runner "
                f"step: {by_variant}")
        require(all(map(math.isfinite, metrics.values())), f"losses {metrics}")
        require(len(waits) == steps, f"{len(waits)} batches for {steps} steps")
        first, last = jsonl(os.path.join(wd, "metrics.jsonl"))
        ms = (last["time"] - first["time"]) * 1e3 / (steps - 1)
        wait_ms = [w * 1e3 for w in waits]
        later = wait_ms[1:]
        out.update({"ms_per_step": ms, "bare_train_step_ms": bare_ms,
                    "batch_wait_ms": wait_ms, "k1_launches": launches,
                    "losses": metrics})
        if native:
            say(f"run_training {name} (native loader): {ms:.3f} ms/step over "
                f"steps 1-{steps - 1} (the runner's log), against "
                f"{python_path['ms_per_step']:.3f} through the python samplers "
                f"(phase {13 if name == 'ucf_ode' else 19}, "
                f"{python_path['batch_bytes'] / 1e6:.1f} MB per step) and "
                f"{bare_ms:.3f} for the bare train_step (TF32 on); the loop "
                f"waited {wait_ms[0]:.3f} ms for step 0's batches and "
                f"{max(later):.3f} ms at most (mean "
                f"{sum(later) / len(later):.3f}) for each later step's; "
                f"{time.perf_counter() - t_phase:.1f} s; {card}")
            return out

        img_s, vid_s = runner.build_data(cfg, synthetic=True)
        gather, copy_ = [], []
        for s in range(3):
            t0 = time.perf_counter()
            ims = runner._stack_d_batches(
                img_s, runner.step_rng(cfg.seed, s, runner.IMAGES), cfg.d_iters)
            vids = runner._stack_d_batches(
                vid_s, runner.step_rng(cfg.seed, s, runner.VIDEOS), cfg.d_iters)
            t1 = time.perf_counter()
            torch.from_numpy(ims).to(dev)
            torch.from_numpy(vids).to(dev)
            torch.cuda.synchronize()
            gather.append((t1 - t0) * 1e3)
            copy_.append((time.perf_counter() - t1) * 1e3)
        batch_bytes = ims.nbytes + vids.nbytes
        host_ms = min(gather) + min(copy_)
        say(f"run_training {name}: {ms:.3f} ms/step over steps 1-"
            f"{steps - 1} (the runner's log), against {bare_ms:.3f} for "
            f"the bare train_step (TF32 on); the host data path alone "
            f"(prefetch runs it ahead, in its own thread): gather "
            f"{min(gather):.3f} ms + pageable copy to the card "
            f"{min(copy_):.3f} ms of {batch_bytes / 1e6:.1f} MB per step "
            f"(least of 3) = {100 * host_ms / ms:.1f} % of a runner step; "
            f"the loop waited {wait_ms[0]:.3f} ms for step 0's batches and "
            f"{max(later):.3f} ms at most (mean {sum(later) / len(later):.3f}) "
            f"for each later step's; {card}")

        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(state.step, state)
        save_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(os.path.join(tmp, "ckpt", str(state.step),
                                            "state.pt"))
        fresh = runner.build_trainer(cfg, device=dev).init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.restore(fresh)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        _, bad = same_state(fresh, state)
        say(f"checkpoint of the full-width {name} state: {size / 2 ** 20:.1f} "
            f"MiB, save {save_ms:.1f} ms, restore {restore_ms:.1f} ms (to the "
            f"card), {len(bad)} tensors differ after the restore; {card}")
        require(not bad, f"restore differs in {bad[:10]}")
        out.update({"host_gather_ms": min(gather), "host_copy_ms": min(copy_),
                    "batch_bytes": batch_bytes, "host_share": host_ms / ms,
                    "checkpoint_bytes": size, "checkpoint_save_ms": save_ms,
                    "checkpoint_restore_ms": restore_ms})
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def resume_phase(card, resume_dir) -> dict:
    """Phase 14: the child below (started by phase 12), in a fresh process
    so that cuBLAS starts with a deterministic workspace."""
    phase("resume on the card, deterministic: 4 steps straight against 2 "
          "steps + STOP + resume to 4 (ucf_ode, full width), on the python "
          "samplers and through the native loader")
    try:
        out, _ = wait_child("resume")
    finally:
        shutil.rmtree(resume_dir, ignore_errors=True)
    rec = json.loads(out.strip().splitlines()[-1])
    for loader, r in rec.items():
        say(f"resume ({loader}): {r['tensors']} tensors compared, "
            f"{len(r['mismatched'])} differ; straight run "
            f"{r['straight_s']:.1f} s, interrupted {r['interrupted_s']:.1f} s, "
            f"resumed {r['resumed_s']:.1f} s (deterministic); {card}")
        require(r["tensors"] > 0 and not r["mismatched"],
                f"the {loader} resume differs in {r['mismatched'][:10]}")
    return rec


def interrupted_resume(runner, cfg, workdir, synthetic) -> dict:
    """``cfg`` at full width, 4 steps straight, then 2 steps with a STOP
    file written during step 1 (as an operator's ``touch`` would), then a
    resume to 4 -> the comparison with the straight run."""
    t0 = time.perf_counter()
    straight, _ = runner.run_training(cfg, os.path.join(workdir, "straight"),
                                      steps=4, synthetic=synthetic)
    t1 = time.perf_counter()
    wd = os.path.join(workdir, "resumed")
    step_generator = runner.step_generator

    def stop_in_step_1(seed, step, stream, device):
        # drawn in the loop's thread as each step starts (the batches are
        # drawn ahead, in prefetch's)
        if step == 1 and stream == runner.TRAIN:
            open(os.path.join(wd, "STOP"), "w").close()
        return step_generator(seed, step, stream, device)

    runner.step_generator = stop_in_step_1
    try:
        half, m = runner.run_training(cfg, wd, steps=4, synthetic=synthetic)
    finally:
        runner.step_generator = step_generator
    require(m.get("preempted") == 2.0 and half.step == 2
            and not os.path.exists(os.path.join(wd, "STOP")),
            f"the STOP file did not halt the run after step 1: {m}")
    del half
    t2 = time.perf_counter()
    resumed, m = runner.run_training(cfg, wd, steps=4, synthetic=synthetic,
                                     resume=True)
    t3 = time.perf_counter()
    require("preempted" not in m and resumed.step == 4, f"resume: {m}")
    n, bad = same_state(resumed, straight)
    return {"tensors": n, "mismatched": bad, "straight_s": t1 - t0,
            "interrupted_s": t2 - t1, "resumed_s": t3 - t2}


def resume_check(workdir) -> int:
    """Phase 14's child: ``interrupted_resume`` of ucf_ode on the python
    samplers, then through the native loader over a pack written here;
    prints both comparisons as one JSON line."""
    import dataclasses

    import torch

    require(torch.cuda.is_available(), "no CUDA card")
    require(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8",
            "CUBLAS_WORKSPACE_CONFIG is not set")
    sys.path.insert(0, REPO)
    from ganode_tpu_torch.train import runner
    from ganode_tpu_torch.utils.config import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    cfg = get_config("ucf_ode", log_every=1, sample_every=0, checkpoint_every=0)
    rec = {"python": interrupted_resume(
        runner, cfg, os.path.join(workdir, "python"), True)}
    native = dataclasses.replace(cfg, data_loader="native", data_path=(
        write_native_pack(cfg, os.path.join(workdir, "pack"))))
    rec["native"] = interrupted_resume(
        runner, native, os.path.join(workdir, "native"), False)
    print(json.dumps(rec), flush=True)
    return 0


def device_data_phase(dev, card) -> dict:
    """Phase 15: mnist_gru at full width, its dataset resident on the card."""
    import torch

    from ganode_tpu_torch.ops import fused_gru, fused_rk4
    from ganode_tpu_torch.train import runner
    from ganode_tpu_torch.utils.config import get_config

    phase(f"mnist_gru at full width through make_device_data_step: "
          f"{DEVICE_DATA_STEPS} steps, synthetic rotated MNIST on the card")
    cfg = get_config("mnist_gru")
    tr = runner.build_trainer(cfg, device=dev)
    state = tr.init_state()
    videos, _ = runner.synthetic_rotmnist(cfg)
    videos = torch.from_numpy(videos).to(dev)
    step = runner.make_device_data_step(tr, cfg.d_iters, cfg.video_length)
    step(state, videos, runner.step_generator(cfg.seed, 0, runner.TRAIN, dev))
    torch.cuda.synchronize()
    reset_counts()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for s in range(1, DEVICE_DATA_STEPS + 1):
        metrics = step(state, videos,
                       runner.step_generator(cfg.seed, s, runner.TRAIN, dev))
    b.record()
    torch.cuda.synchronize()
    by_variant = dict(fused_gru.launches_by_variant)
    launches = fused_gru.launches
    ms = a.elapsed_time(b) / DEVICE_DATA_STEPS
    losses = {k: v.item() for k, v in metrics.items()}
    say(f"mnist_gru device-data step: K2 launches {by_variant} in "
        f"{DEVICE_DATA_STEPS} steps, K1 {fused_rk4.launches}; {ms:.3f} ms/step "
        f"after one warm-up step ({tuple(videos.shape)} resident, "
        f"{videos.numel() * 4 / 1e6:.1f} MB); losses {losses}; {card}")
    require(by_variant == {"warp": 6 * DEVICE_DATA_STEPS, "wide": 0}
            and fused_rk4.launches == 0,
            f"K2 did not launch exactly 6 times per step: {by_variant}")
    require(all(map(math.isfinite, losses.values())), f"losses {losses}")
    return {"ms_per_step": ms, "k2_launches": launches, "losses": losses,
            "dataset_bytes": videos.numel() * 4}


def step_flops(cfg) -> dict:
    """Floating-point operations of one ``train_step`` of ``cfg``, counted
    from the shapes on the meta device (no data, no card): torch's per-op
    formulas (``torch.utils.flop_counter``) for every convolution and
    product of the trunk's samples, each D update (real and fake passes, the
    gradient penalty's pass with its double backward, the weight gradients)
    and the G update (samples with gradients through both critics). The
    motion solves (~1e-5 of the total) and element-wise work are left out.
    Runs on the CPU: ``python3 -c "import chip_smoke as c; from
    ganode_tpu_torch.utils.config import get_config as g;
    print(c.step_flops(g('ucf_wgan_gp_128')))"``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    from ganode_tpu_torch.train import NetState, build_trainer

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            f = flop_registry.get(func._overloadpacket)
            if f is not None:
                self.total += f(*args, **(kwargs or {}), out_val=out)
            return out

    def count(fn):
        with Count() as c:
            fn()
        return c.total

    tr = build_trainer(cfg, device="cpu")
    for net in (tr.gen, tr.dis_img, tr.dis_vid):
        net.to("meta")
    b, t, s = cfg.batch_size, cfg.video_length, FRAME_SIZE[cfg.trunk]
    dim_z = cfg.dim_z_content + cfg.dim_z_category + cfg.dim_z_motion
    img = torch.zeros((b, s, s, cfg.n_channels), device="meta")
    vid = torch.zeros((b, t, s, s, cfg.n_channels), device="meta")

    tr._apply = lambda *a: None  # count the gradients, take no step

    def d_update(mod, real):
        return lambda: tr._d_update(NetState(mod, None), real, real, None,
                                    gp_eps=torch.zeros((b,) + (1,) * (
                                        real.ndim - 1), device="meta"))

    def g_update():
        zv = torch.zeros((b * t, dim_z), device="meta", requires_grad=True)
        zi = torch.zeros((b, dim_z), device="meta", requires_grad=True)
        v = tr.gen.main(zv).reshape(b, t, cfg.n_channels, s, s)
        i = tr.gen.main(zi)
        loss = (tr.g_loss_fn(tr.dis_vid(v.permute(0, 1, 3, 4, 2))[0])
                + tr.g_loss_fn(tr.dis_img(i.permute(0, 2, 3, 1))[0]))
        torch.autograd.grad(loss, list(tr.gen.main.parameters()))

    with torch.no_grad():
        samples = count(lambda: tr.gen.main(
            torch.zeros((b * t + b, dim_z), device="meta")))
    out = {"samples": samples, "d_img_update": count(d_update(tr.dis_img, img)),
           "d_vid_update": count(d_update(tr.dis_vid, vid)),
           "g_update": count(g_update)}
    out["step"] = (cfg.d_iters * (out["samples"] + out["d_img_update"]
                                  + out["d_vid_update"]) + out["g_update"])
    return out


def sn_convs(critic):
    from ganode_tpu_torch.nn import SNConv

    return [m for m in critic.modules() if isinstance(m, SNConv)]


def wgan_phases(dev, card, events_ms) -> dict:
    """Phases 16-18 (module docstring); returns the record's entry."""
    import torch

    from ganode_tpu_torch.models.motion import MotionODE
    from ganode_tpu_torch.ode import adaptive
    from ganode_tpu_torch.ops import fused_gru, fused_rk4
    from ganode_tpu_torch.train import build_trainer
    from ganode_tpu_torch.utils.config import get_config

    cfg = get_config("ucf_wgan_gp_128")
    d = cfg.d_iters
    phase(f"train ucf_wgan_gp_128 at full width (dcgan128, ngf=ndf="
          f"{cfg.ngf}, B={cfg.batch_size}, T={cfg.video_length}, 128x128x3, "
          f"SN critics, GP {cfg.gp_weight}, d_iters {d}, dopri5 rtol 1e-5 "
          f"atol 1e-6): 1 warm-up + {WGAN_STEPS} timed steps, cuDNN TF32 on "
          "(PyTorch's default)")
    torch.backends.cudnn.allow_tf32 = True
    tr = build_trainer(cfg, device=dev)
    state = tr.init_state()
    gt = torch.Generator(dev).manual_seed(0)
    images, videos = random_batches(cfg, dev, 0)
    critics = {"dis_img": tr.dis_img, "dis_vid": tr.dis_vid}
    advances = dict.fromkeys(critics, 0)

    def count_advances(key):
        def hook(module, args, kwargs):
            advances[key] += bool(kwargs["update_stats"])
        return hook

    hooks = [c.SNConv_0.register_forward_pre_hook(count_advances(k),
                                                  with_kwargs=True)
             for k, c in critics.items()]
    t0 = time.perf_counter()
    tr.train_step(state, images, videos, generator=gt)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    adaptive.tally.clear()
    advances.update(dict.fromkeys(critics, 0))
    u_before = {k: [m.u.clone() for m in sn_convs(c)]
                for k, c in critics.items()}
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(WGAN_STEPS):
        metrics = tr.train_step(state, images, videos, generator=gt)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / WGAN_STEPS
    mem = torch.cuda.max_memory_allocated()
    k1, k2 = fused_rk4.launches, fused_gru.launches
    tally = dict(adaptive.tally)
    per_step = {k: v / WGAN_STEPS for k, v in advances.items()}
    for h in hooks:
        h.remove()
    losses = {k: v.item() for k, v in metrics.items()}
    say(f"ucf_wgan_gp_128 train_step: K1 launches {k1}, K2 {k2} in "
        f"{WGAN_STEPS} steps (dopri5 runs no kernel, as in JAX); u advances "
        f"per step {per_step}; dopri5 solves {tally}")
    require(k1 == 0 and k2 == 0, f"K1 {k1} / K2 {k2} launched on the dopri5 "
            "path")
    require(all(map(math.isfinite, losses.values())), f"losses {losses}")
    # u advances once per train-mode forward: real and fake passes of each D
    # update, and once in the G update; the penalty pass keeps it
    want_adv = 2 * d + 1
    require(all(v == want_adv for v in per_step.values()),
            f"u advanced {per_step} times per step, not {want_adv}")
    norms = {f"{k}.SNConv_{i}": m.u.norm().item()
             for k, c in critics.items() for i, m in enumerate(sn_convs(c))}
    require(all(abs(n - 1.0) <= TOL_U_NORM for n in norms.values()),
            f"u norms {norms}")
    # (the last layers have one output: their u is +-1 and cannot move)
    moved = all(not torch.equal(m.u, u0) for k, c in critics.items()
                for m, u0 in zip(sn_convs(c), u_before[k]) if m.u.numel() > 1)
    require(moved, "a u did not move in the timed steps")
    want_fwd, want_bwd = WGAN_STEPS * (2 * d + 2), WGAN_STEPS * 2
    require(tally.get("forward_calls") == want_fwd
            and tally.get("backward_calls") == want_bwd,
            f"dopri5 solves {tally}, want {want_fwd} forward and {want_bwd} "
            "backward")
    require(tally["forward_exhausted"] == 0 and tally["backward_exhausted"] == 0,
            f"dopri5 ran out of steps: {tally}")
    solve = {kind: {s: tally[f"{kind}_{s}"] / tally[f"{kind}_calls"]
                    for s in ("nfe", "accepted", "rejected", "syncs")}
             for kind in ("forward", "backward")}
    phases = phase_ms(tr, state, images, videos, gt, 1)
    flops = step_flops(cfg)

    m = tr.gen.motion
    params = list(m.parameters())

    def fwd():
        with torch.no_grad():
            m(cfg.batch_size, cfg.video_length, generator=gt)

    def fwd_bwd():
        zs = m(cfg.batch_size, cfg.video_length, generator=gt)
        torch.autograd.grad(zs.sum(), params)

    solve_ms = {"forward": events_ms(fwd, 5), "forward_backward":
                events_ms(fwd_bwd, 3)}
    say(f"ucf_wgan_gp_128 train_step (cuDNN TF32 on): {ms:.3f} ms/step, "
        f"{cfg.batch_size * 1e3 / ms:.2f} clips/s (warm-up step {warm_s:.1f} "
        f"s); phases per step: D_img {phases['d_img']:.3f} ms, D_vid (with "
        f"the GP) {phases['d_vid']:.3f} ms, G {phases['g']:.3f} ms; peak "
        f"memory {mem / 2 ** 30:.2f} GiB; {flops['step'] / 1e12:.2f} TFLOP "
        f"per step counted from the shapes (D_vid updates "
        f"{d * flops['d_vid_update'] / 1e12:.2f}), so "
        f"{flops['step'] / ms / 1e9:.1f} TFLOP/s over the step and "
        f"{d * flops['d_vid_update'] / phases['d_vid'] / 1e9:.1f} in D_vid; "
        f"losses {losses}; {card}")
    say(f"dopri5 per solve (B={cfg.batch_size}, T={cfg.video_length}, "
        f"dim {cfg.dim_z_motion}): forward {solve['forward']}, adjoint "
        f"backward {solve['backward']}; steps_exhausted none; forward alone "
        f"{solve_ms['forward']:.3f} ms, forward + adjoint backward "
        f"{solve_ms['forward_backward']:.3f} ms; u norms within "
        f"{max(abs(n - 1) for n in norms.values()):.2e} of 1; {card}")
    rec = {"config": "ucf_wgan_gp_128", "batch": cfg.batch_size,
           "frames": cfg.video_length, "d_iters": d, "card": card,
           "ms_per_step": ms, "clips_per_s": cfg.batch_size * 1e3 / ms,
           "warmup_step_s": warm_s, "phase_ms": phases,
           "max_memory_bytes": mem, "losses": losses, "flops": flops,
           "u_advances_per_step": per_step, "dopri5_per_solve": solve,
           "dopri5_solve_ms": solve_ms, "k1_launches": k1,
           "k2_launches": k2}
    del tr, state, images, videos, m, params
    torch.cuda.empty_cache()

    phase("one ucf_wgan_gp_128 step at reduced width (ngf=ndf=8, B=4, T=16, "
          "d_iters 2): card vs CPU float64")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        err_loss, err_nets, cpu_loss, cpu_nets, n_tensors = card_vs_cpu_step(
            dev, get_config("ucf_wgan_gp_128", ngf=8, ndf=8, batch_size=4,
                            video_length=16, d_iters=2))
    finally:
        torch.backends.cudnn.deterministic = False
    say(f"WGAN-GP train_step vs the CPU's float64 step: card (float32, TF32 "
        f"off, cuDNN deterministic) losses max|diff| {err_loss:.3e}, "
        f"parameters, u and Adam moments max|diff| {err_nets:.3e} over "
        f"{n_tensors} tensors (tol {TOL_STEP}); the CPU's float32 step "
        f"{cpu_loss:.3e} and {cpu_nets:.3e}")
    require(err_loss < TOL_STEP and err_nets < TOL_STEP,
            f"WGAN-GP card vs CPU: losses {err_loss}, nets {err_nets}")
    rec["card_vs_cpu_max_abs"] = {"losses": err_loss, "nets": err_nets,
                                  "cpu_float32_losses": cpu_loss,
                                  "cpu_float32_nets": cpu_nets}

    phase("dopri5 motion and its adjoint gradient: card vs CPU float64 "
          f"(B={cfg.batch_size}, T={cfg.video_length}, dim 16)")
    motion = MotionODE(cfg.dim_z_motion, method="dopri5")
    motion.init_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    x0 = torch.randn((cfg.batch_size, cfg.dim_z_motion), generator=g)
    w = torch.randn((cfg.batch_size, cfg.video_length, cfg.dim_z_motion),
                    generator=g)

    def solve_on(device, dtype):
        mod = copy.deepcopy(motion).to(device, dtype)
        adaptive.tally.clear()
        zs = mod(cfg.batch_size, cfg.video_length, x0=x0.to(device, dtype))
        grads = torch.autograd.grad((zs * w.to(device, dtype)).sum(),
                                    list(mod.parameters()))
        return (zs.detach().cpu().double(), [t.cpu().double() for t in grads],
                dict(adaptive.tally))

    z_card, g_card, st_card = solve_on(dev, torch.float32)
    z_ref, g_ref, st_ref = solve_on("cpu", torch.float64)
    traj = ((z_card - z_ref).abs()
            / (motion.atol + motion.rtol * z_ref.abs())).max().item()
    grad = max(((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(g_card, g_ref))
    say(f"dopri5 card (float32) vs CPU (float64): trajectory max|diff| / "
        f"(atol + rtol |y|) = {traj:.3e} (tol 1), adjoint gradients worst "
        f"max|diff|/max|ref| {grad:.3e} (tol {TOL_DOPRI_GRAD}); card solves "
        f"{st_card}, CPU {st_ref}")
    require(traj <= 1.0 and grad <= TOL_DOPRI_GRAD,
            f"dopri5 card vs CPU: trajectory {traj}, gradients {grad}")
    rec["dopri5_card_vs_cpu"] = {"trajectory_over_tol": traj,
                                 "grad_rel": grad}
    return rec


def bf16_phase(dev, card, f32_ms, events_ms) -> dict:
    """Phase 20: the ucf_ode step with compute_dtype="bfloat16", and the
    video discriminator's forward and backward alone at the training shape
    in float32 (TF32) and bf16, with cuDNN's benchmark off (as everywhere
    else here) and on."""
    import torch

    from ganode_tpu_torch.ops import fused_gru, fused_rk4
    from ganode_tpu_torch.train import build_trainer
    from ganode_tpu_torch.utils.config import get_config

    phase("train ucf_ode at full width with compute_dtype=bfloat16 (trunk "
          f"and discriminators in bf16, float32 params): 2 warm-up + "
          f"{TRAIN_STEPS} timed steps, cuDNN TF32 on")
    torch.backends.cudnn.allow_tf32 = True
    cfg = get_config("ucf_ode", compute_dtype="bfloat16")
    tr = build_trainer(cfg, device=dev)
    state = tr.init_state()
    gt = torch.Generator(dev).manual_seed(0)
    images, videos = random_batches(cfg, dev, 0)
    for _ in range(2):
        tr.train_step(state, images, videos, generator=gt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(TRAIN_STEPS):
        metrics = tr.train_step(state, images, videos, generator=gt)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / TRAIN_STEPS
    mem = torch.cuda.max_memory_allocated()
    by_variant = dict(fused_rk4.launches_by_variant)
    k1_per_step = fused_rk4.launches / TRAIN_STEPS
    losses = {k: v.item() for k, v in metrics.items()}
    phases = phase_ms(tr, state, images, videos, gt, 3)
    say(f"ucf_ode train_step, bf16 compute (cuDNN TF32 on): {ms:.3f} ms/step, "
        f"{cfg.batch_size * 1e3 / ms:.1f} clips/s, against {f32_ms:.3f} in "
        f"float32 (phase 8, TF32 on); phases per step: D_img "
        f"{phases['d_img']:.3f} ms, D_vid {phases['d_vid']:.3f} ms, G "
        f"{phases['g']:.3f} ms; peak memory {mem / 2 ** 30:.2f} GiB; K1 "
        f"{by_variant}; losses {losses}; {card}")
    require(by_variant == {"warp": 6 * TRAIN_STEPS, "wide": 0}
            and fused_gru.launches == 0,
            f"K1 did not launch exactly 6 times per step: {by_variant}")
    require(all(map(math.isfinite, losses.values())), f"losses {losses}")
    require(all(p.dtype == torch.float32 for p in tr.gen.parameters()),
            "a bf16 run changed a parameter's dtype")

    from ganode_tpu_torch.models import make_discriminator

    d_vid_ms = {}
    x = videos[0]
    for dtype in (None, torch.bfloat16):
        mod = make_discriminator("full", True, n_channels=3, ksize=4,
                                 device=dev, dtype=dtype)
        params = list(mod.parameters())

        def fwd_bwd():
            torch.autograd.grad(mod(x)[0].sum(), params)

        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            d_vid_ms[f"{'bf16' if dtype else 'float32'} cudnn.benchmark "
                     f"{'on' if bench else 'off'}"] = events_ms(fwd_bwd, 5)
    torch.backends.cudnn.benchmark = False
    say(f"VideoDiscriminator(ksize=4) forward + backward alone, B="
        f"{cfg.batch_size}, T={cfg.video_length}, 64x64x3, cuDNN TF32 on: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in d_vid_ms.items())
        + f"; {card}")
    return {"ms_per_step": ms, "clips_per_s": cfg.batch_size * 1e3 / ms,
            "float32_ms_per_step": f32_ms, "phase_ms": phases,
            "max_memory_bytes": mem, "losses": losses,
            "k1_launches_per_step": k1_per_step,
            "video_disc_fwd_bwd_ms": d_vid_ms}


VARIANTS = ("mnist_sde", "mnist_cde", "mnist_ode_rnn", "mnist_moe_ode")


def variant_phases(dev, card, events_ms, sde_cli) -> dict:
    """Phases 21-25 (module docstring): the SDE, CDE, ODE-RNN and MoE-ODE
    configs, which run no kernel, as in JAX; returns the record's entry.
    ``sde_cli``: (the mnist_sde command line's directory, its seconds),
    run beside phase 12."""
    import torch

    from ganode_tpu_torch.compat import GeneratorSession
    from ganode_tpu_torch.models import MotionSDE, generator_for_config
    from ganode_tpu_torch.ode import brownian_increments
    from ganode_tpu_torch.ops import fused_gru, fused_rk4
    from ganode_tpu_torch.train import build_trainer
    from ganode_tpu_torch.utils import layout
    from ganode_tpu_torch.utils.config import get_config

    out = {}
    for name in VARIANTS:
        cfg = get_config(name)
        t0 = time.perf_counter()
        phase(f"train {name} at full width (mnist28, ngf=ndf={cfg.ngf}, "
              f"B={cfg.batch_size}, T={cfg.video_length}, d_iters "
              f"{cfg.d_iters}): 2 warm-up + {VARIANT_STEPS} timed steps, "
              "cuDNN TF32 on")
        torch.backends.cudnn.allow_tf32 = True
        tr = build_trainer(cfg, device=dev)
        state = tr.init_state()
        gt = torch.Generator(dev).manual_seed(0)
        images, videos = random_batches(cfg, dev, 2)
        for _ in range(2):
            tr.train_step(state, images, videos, generator=gt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(VARIANT_STEPS):
            metrics = tr.train_step(state, images, videos, generator=gt)
        b.record()
        torch.cuda.synchronize()
        k1, k2 = fused_rk4.launches, fused_gru.launches
        ms = a.elapsed_time(b) / VARIANT_STEPS
        mem = torch.cuda.max_memory_allocated()
        losses = {k: v.item() for k, v in metrics.items()}
        require(k1 == 0 and k2 == 0,
                f"{name} launched K1 {k1} and K2 {k2} times: a path took a "
                "kernel that JAX does not take")
        require(all(map(math.isfinite, losses.values())),
                f"{name}: non-finite losses {losses}")
        phases = phase_ms(tr, state, images, videos, gt, 1)
        say(f"{name} train_step: {ms:.3f} ms/step, "
            f"{cfg.batch_size * 1e3 / ms:.1f} clips/s; phases per step: "
            f"D_img {phases['d_img']:.3f} ms, D_vid {phases['d_vid']:.3f} ms, "
            f"G {phases['g']:.3f} ms; peak memory {mem / 2 ** 30:.2f} GiB; "
            f"K1 +{k1}, K2 +{k2} in {VARIANT_STEPS} steps; losses {losses}; "
            f"{time.perf_counter() - t0:.1f} s; {card}")
        rec = {"ms_per_step": ms, "clips_per_s": cfg.batch_size * 1e3 / ms,
               "phase_ms": phases, "max_memory_bytes": mem, "losses": losses,
               "k1_launches_per_step": k1 / VARIANT_STEPS,
               "k2_launches_per_step": k2 / VARIANT_STEPS}
        del tr, state, images, videos

        t0 = time.perf_counter()
        phase(f"serve {name} at full width: sample_videos(64), and 2 clips "
              "against the CPU")
        torch.backends.cudnn.allow_tf32 = False
        sess = GeneratorSession(generator_for_config(cfg, device=dev), seed=0,
                                device=dev)
        reset_counts()
        v = layout.video_from_torch(sess.sample_videos(64)[0])
        torch.cuda.synchronize()
        k1, k2 = fused_rk4.launches, fused_gru.launches
        want = (64, cfg.video_length, 28, 28, cfg.n_channels)
        require(tuple(v.shape) == want, f"{name} videos {tuple(v.shape)}")
        require(bool(torch.isfinite(v).all()) and v.abs().max().item() <= 1.0,
                f"{name}: videos not finite or outside [-1, 1]")
        require(k1 == 0 and k2 == 0, f"{name} served through K1 {k1} / K2 {k2}")
        gen, gen_cpu = sess.gen, generator_for_config(cfg, device="cpu").eval()
        noise = gen.draw_noise(2, "videos", torch.Generator().manual_seed(5))
        with torch.no_grad():
            v_card, _ = gen.sample_videos(
                2, **{k: x.to(dev) for k, x in noise.items()})
            v_cpu, _ = gen_cpu.sample_videos(2, **noise)
        err = (v_card.cpu() - v_cpu).abs().max().item()
        require(err < TOL_VIDEO, f"{name} card vs CPU videos: {err}")
        serve = {}
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            serve[f"tf32={'on' if tf32 else 'off'}"] = events_ms(
                lambda: sess.sample_videos(64), 5)
        with torch.no_grad():
            motion_ms = events_ms(
                lambda: gen.motion(64, cfg.video_length,
                                   generator=sess.generator), 5)
        say(f"{name} sample_videos(64): {serve['tf32=off']:.3f} ms TF32 off, "
            f"{serve['tf32=on']:.3f} ms on ({64e3 / serve['tf32=on']:.0f} "
            f"clips/s); motion alone {motion_ms:.3f} ms; card vs CPU (2 "
            f"clips, TF32 off) max|diff| {err:.3e} (tol {TOL_VIDEO}); K1 +{k1}, "
            f"K2 +{k2}; {time.perf_counter() - t0:.1f} s; {card}")
        rec["serving_ms"] = serve
        rec["serving_motion_ms"] = motion_ms
        rec["serving_card_vs_cpu_max_abs"] = err
        out[name] = rec
        del sess, gen, gen_cpu

    for name in ("mnist_sde", "mnist_cde"):
        t0 = time.perf_counter()
        phase(f"one {name} train_step at reduced width (ngf=ndf=8, B=4, "
              "T=16): card vs CPU float64")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        try:
            err_loss, err_nets, cpu_loss, cpu_nets, n_tensors = \
                card_vs_cpu_step(dev, get_config(name, ngf=8, ndf=8,
                                                 batch_size=4))
        finally:
            torch.backends.cudnn.deterministic = False
        say(f"{name} train_step vs the CPU's float64 step: card (float32, "
            f"TF32 off, cuDNN deterministic) losses max|diff| {err_loss:.3e}, "
            f"parameters, statistics and Adam moments max|diff| "
            f"{err_nets:.3e} over {n_tensors} tensors (tol {TOL_STEP}); the "
            f"CPU's float32 step {cpu_loss:.3e} and {cpu_nets:.3e}; "
            f"{time.perf_counter() - t0:.1f} s")
        require(err_loss < TOL_STEP and err_nets < TOL_STEP,
                f"{name} card vs CPU: losses {err_loss}, nets {err_nets}")
        out[name]["card_vs_cpu_max_abs"] = {
            "losses": err_loss, "nets": err_nets,
            "cpu_float32_losses": cpu_loss, "cpu_float32_nets": cpu_nets}

    t0 = time.perf_counter()
    b, d, t, dt = 32, 16, 16, 2.5e-2
    phase(f"SDE solvers on the card (B={b}, dim {d}, T={t}, dt {dt}) against "
          "the CPU in float64 from the same x0 and dW; the reversible "
          "adjoint's gradients against autograd")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(11)
    x0 = torch.randn((b, d), generator=g)
    ts = MotionSDE.times(t)
    dW = brownian_increments(ts, dt, (b, d), g)
    require(dW.shape[0] == 45, f"{dW.shape[0]} substeps, not 45")
    w = torch.randn((b, t, d), generator=g)
    base = MotionSDE(d)
    base.init_parameters(torch.Generator().manual_seed(0))
    solver = {}
    for method in ("euler", "milstein", "reversible_heun"):
        def run(device, dtype, method=method):
            m = copy.deepcopy(base).to(device, dtype)
            m.method = method
            with torch.no_grad():
                return m(b, t, x0=x0.to(device, dtype),
                         dW=dW.to(device, dtype)).cpu().double()
        got, want = run(dev, torch.float32), run("cpu", torch.float64)
        err = (got - want).abs().max().item()
        require(bool(torch.isfinite(got).all()) and err < TOL_STEP,
                f"sdeint {method} card vs CPU float64: {err}")
        solver[method] = {"max_abs_vs_float64": err}

    m = copy.deepcopy(base).to(dev)
    x, dW_d, w_d = x0.to(dev), dW.to(dev), w.to(dev)
    params = list(m.drift_fn.parameters()) + list(m.diffusion_fn.parameters())

    def grads(method):
        m.method = method
        xi = x.clone().requires_grad_()
        zs = m(b, t, x0=xi, dW=dW_d)
        return torch.autograd.grad((zs * w_d).sum(), [xi] + params)

    adj, ref = grads("reversible_heun_adjoint"), grads("reversible_heun")
    grad_err = max(((a_ - r).abs().max() / r.abs().max()).item()
                   for a_, r in zip(adj, ref))
    require(grad_err < TOL_STEP, f"reversible adjoint vs autograd: {grad_err}")
    adj_ms = events_ms(lambda: grads("reversible_heun_adjoint"), 3)
    ref_ms = events_ms(lambda: grads("reversible_heun"), 3)
    say(f"SDE card (float32) vs CPU (float64), max|diff| over 45 substeps: "
        + ", ".join(f"{k} {v['max_abs_vs_float64']:.3e}"
                    for k, v in solver.items())
        + f" (tol {TOL_STEP}); reversible adjoint vs autograd through "
        f"reversible_heun on the card, gradients in x0 and the 8 field "
        f"tensors worst max|diff|/max|ref| {grad_err:.3e} (tol {TOL_STEP}); "
        f"forward + backward {adj_ms:.3f} ms (adjoint) against "
        f"{ref_ms:.3f} ms (autograd); {time.perf_counter() - t0:.1f} s; "
        f"{card}")
    solver["adjoint_vs_autograd_grad_rel"] = grad_err
    solver["adjoint_ms"], solver["autograd_ms"] = adj_ms, ref_ms
    out["sde_solvers"] = solver

    phase("the training CLI: python -m ganode_tpu_torch.train --config "
          "mnist_sde --synthetic --steps 2 (full width), run beside phase 12")
    tmp, seconds = sde_cli
    try:
        wd = os.path.join(tmp, "run")
        lines = jsonl(os.path.join(wd, "metrics.jsonl"))
        losses = [{k: l[k] for k in ("dis_img_loss", "dis_vid_loss",
                                     "gen_loss")} for l in lines]
        require([l["step"] for l in lines] == [0, 1]
                and all(math.isfinite(v) for l in losses for v in l.values()),
                f"mnist_sde metrics.jsonl: {lines}")
        ckpts = sorted(int(c) for c in os.listdir(os.path.join(wd, "checkpoints")))
        ckpt = os.path.join(wd, "checkpoints", str(ckpts[-1]), "state.pt")
        require(ckpts and ckpts[-1] == 2 and os.path.getsize(ckpt) > 0,
                f"mnist_sde checkpoints {ckpts}")
        say(f"mnist_sde CLI: 2 steps in {seconds:.1f} s of process, beside "
            f"phase 12's two; losses "
            f"{losses}; checkpoints {ckpts} ({os.path.getsize(ckpt)} bytes); "
            f"{card}")
        out["mnist_sde_cli"] = {"seconds": seconds, "losses": losses,
                                "checkpoint_bytes": os.path.getsize(ckpt)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def timed_steps(tr, state, images, videos, generator, warmup, n):
    """``warmup`` steps, then ``n`` timed between CUDA events with the
    kernel counts from 0 -> (ms per step, peak memory, the last metrics,
    K1 and K2 launches, ADA's p after each timed step)."""
    import torch

    from ganode_tpu_torch.ops import fused_gru, fused_rk4

    for _ in range(warmup):
        tr.train_step(state, images, videos, generator=generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ps = []
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        metrics = tr.train_step(state, images, videos, generator=generator)
        if state.ada is not None:
            ps.append(dict(state.ada))     # device tensors: no sync here
    b.record()
    torch.cuda.synchronize()
    ps = [{k: v.item() for k, v in p.items()} for p in ps]
    return (a.elapsed_time(b) / n, torch.cuda.max_memory_allocated(),
            {k: v.item() for k, v in metrics.items()}, fused_rk4.launches,
            fused_gru.launches, ps)


def diffaug_phases(dev, card, events_ms, wgan_ms) -> dict:
    """Phases 26-30 (module docstring): DiffAugment and ADA; returns the
    record's entry."""
    import numpy as np
    import torch

    from ganode_tpu_torch.compat import GeneratorSession
    from ganode_tpu_torch.train import build_trainer
    from ganode_tpu_torch.train.diffaug import diff_augment, diffaug_draws
    from ganode_tpu_torch.utils import gifs, layout
    from ganode_tpu_torch.utils.checkpoint import CheckpointManager
    from ganode_tpu_torch.utils.config import get_config

    out = {}
    t0 = time.perf_counter()
    phase("DiffAugment on the card against the CPU, same draws: each op and "
          "the policy, ungated and gated at p 0, 0.5, 1")
    g = torch.Generator().manual_seed(3)
    shapes = {"mnist_ode video": (32, 16, 28, 28, 1),
              "ucf_wgan_gp_128 image": (32, 128, 128, 3)}
    worst = {"exact": 0.0, "color": 0.0}
    n_checks = 0
    for shape in shapes.values():
        x = torch.rand(shape, generator=g) * 2 - 1
        xd = x.to(dev)
        for op in ("brightness", "saturation", "contrast", "translation",
                   "cutout", DIFFAUG):
            draws = diffaug_draws(op, shape, True, g)
            plain = diff_augment(xd, op, draws=draws)
            for p in (None, 0.0, 0.5, 1.0):
                pt = None if p is None else torch.tensor(p)
                got = diff_augment(xd, op, None if pt is None else pt.to(dev),
                                   draws=draws)
                err = (got.cpu() - diff_augment(x, op, pt, draws=draws)
                       ).abs().max().item()
                kind = "exact" if op in ("translation", "cutout") else "color"
                worst[kind] = max(worst[kind], err)
                require(err == 0.0 if kind == "exact" else err <= TOL_COLOR,
                        f"diff_augment {op} p={p} card vs CPU {err}")
                if p == 1.0:
                    require(torch.equal(got, plain),
                            f"diff_augment {op}: p=1 is not the ungated result")
                if p == 0.0:
                    require(torch.equal(got, xd),
                            f"diff_augment {op}: p=0 is not the identity")
                n_checks += 1
    vshape = (32, 32, 128, 128, 3)   # ucf_wgan_gp_128's video batch
    v = torch.rand(vshape, device=dev)
    vdraws = diffaug_draws(DIFFAUG, vshape, True, torch.Generator().manual_seed(4))
    half = torch.tensor(0.5, device=dev)
    with torch.no_grad():
        policy_ms = events_ms(lambda: diff_augment(v, DIFFAUG, draws=vdraws), 5)
        gated_ms = events_ms(lambda: diff_augment(v, DIFFAUG, half,
                                                  draws=vdraws), 5)
    mb = v.numel() * 4 / 1e6
    say(f"diff_augment card vs CPU: {n_checks} checks at {list(shapes)}; "
        f"translation and cutout max|diff| {worst['exact']:.1e} (exact), "
        f"colour ops {worst['color']:.3e} (tol {TOL_COLOR}); p=1 equal to "
        f"the ungated result, p=0 the identity; the policy on one "
        f"{vshape} video batch ({mb:.1f} MB, float32): {policy_ms:.3f} ms "
        f"ungated, {gated_ms:.3f} ms gated at p=0.5 (eager, no grad); "
        f"{time.perf_counter() - t0:.1f} s; {card}")
    out["diff_augment"] = {"checks": n_checks, "max_abs_exact": worst["exact"],
                           "max_abs_color": worst["color"],
                           "video_batch_ms": policy_ms,
                           "video_batch_gated_ms": gated_ms,
                           "video_batch_mb": mb}
    del v, vdraws

    t0 = time.perf_counter()
    phase("train mnist_ode at full width with DEMO_RESULTS_ADA's options "
          f"({ADA_RUN}) and without: 2 warm-up + {DIFFAUG_STEPS} timed steps "
          "each, in turns, cuDNN TF32 on")
    torch.backends.cudnn.allow_tf32 = True
    rec = {}
    runs = {"ada": [], "plain": []}
    trainers = {}
    for name, kw in (("ada", ADA_RUN), ("plain", {})):
        cfg = get_config("mnist_ode", **kw)
        tr = build_trainer(cfg, device=dev)
        trainers[name] = (cfg, tr, tr.init_state(),
                          torch.Generator(dev).manual_seed(0))
    images, videos = random_batches(trainers["ada"][0], dev, 5)
    for name in ("ada", "plain", "plain", "ada"):
        cfg, tr, state, gt = trainers[name]
        runs[name].append(timed_steps(tr, state, images, videos, gt, 2,
                                      DIFFAUG_STEPS))
    for name, results in runs.items():
        cfg, tr, state, gt = trainers[name]
        ms = [r[0] for r in results]
        mem, losses, k1, k2 = results[-1][1:5]
        per_step = [r[3] / DIFFAUG_STEPS for r in results]
        require(all(math.isfinite(v) for r in results for v in r[2].values()),
                f"mnist_ode {name}: non-finite losses {losses}")
        require(all(r[4] == 0 for r in results), f"mnist_ode {name}: K2 {k2}")
        phases = phase_ms(tr, state, images, videos, gt, 1)
        rec[name] = {"ms_per_step": ms, "max_memory_bytes": mem,
                     "losses": losses, "k1_launches_per_step": per_step,
                     "k2_launches": sum(r[4] for r in results),
                     "phase_ms": phases}
        if name == "ada":
            ps = [p for r in results for p in r[5]]
            require(len(ps) == 2 * DIFFAUG_STEPS and all(
                0.0 <= v <= cfg.ada_p_max for p in ps for v in p.values()),
                f"ADA p out of [0, {cfg.ada_p_max}]: {ps}")
            require(all(v.device.type == "cuda" and v.dtype == torch.float32
                        for v in state.ada.values()), "ADA p left the card")
            rec[name]["p_after_each_step"] = ps
        say(f"mnist_ode {name} train_step: {' / '.join(f'{m:.3f}' for m in ms)} "
            f"ms/step (two turns); phases per step: D_img "
            f"{phases['d_img']:.3f} ms, D_vid {phases['d_vid']:.3f} ms, G "
            f"{phases['g']:.3f} ms; peak memory {mem / 2 ** 30:.2f} GiB; K1 "
            f"launches per step {per_step}, K2 +{k2}; losses {losses}"
            + (f"; p after each step {rec[name]['p_after_each_step']}"
               if name == "ada" else "") + f"; {card}")
    require(rec["ada"]["k1_launches_per_step"] == rec["plain"][
        "k1_launches_per_step"] == [6.0, 6.0],
            f"K1 per step: augmented {rec['ada']['k1_launches_per_step']}, "
            f"plain {rec['plain']['k1_launches_per_step']}")
    say(f"mnist_ode: the ADA step {np.mean(rec['ada']['ms_per_step']):.3f} "
        f"ms against {np.mean(rec['plain']['ms_per_step']):.3f} unaugmented "
        f"(means of two turns); {time.perf_counter() - t0:.1f} s; {card}")
    out["mnist_ode_ada"] = rec
    del trainers, images, videos

    t0 = time.perf_counter()
    phase(f"train ucf_wgan_gp_128 at full width with diffaug={DIFFAUG}: 1 "
          f"warm-up + {WGAN_DIFFAUG_STEPS} timed steps, cuDNN TF32 on")
    cfg = get_config("ucf_wgan_gp_128", diffaug=DIFFAUG)
    tr = build_trainer(cfg, device=dev)
    state = tr.init_state()
    gt = torch.Generator(dev).manual_seed(0)
    images, videos = random_batches(cfg, dev, 0)
    ms, mem, losses, k1, k2, _ = timed_steps(tr, state, images, videos, gt, 1,
                                             WGAN_DIFFAUG_STEPS)
    require(k1 == 0 and k2 == 0, f"ucf_wgan_gp_128 + diffaug: K1 {k1} / K2 {k2}")
    require(all(map(math.isfinite, losses.values())), f"losses {losses}")
    phases = phase_ms(tr, state, images, videos, gt, 1)
    say(f"ucf_wgan_gp_128 + diffaug train_step: {ms:.3f} ms/step against "
        f"{wgan_ms:.3f} unaugmented (phase 16, this run); phases per step: "
        f"D_img {phases['d_img']:.3f} ms, D_vid {phases['d_vid']:.3f} ms, G "
        f"{phases['g']:.3f} ms; peak memory {mem / 2 ** 30:.2f} GiB; K1 +{k1}, "
        f"K2 +{k2}; losses {losses}; {time.perf_counter() - t0:.1f} s; {card}")
    out["ucf_wgan_gp_128_diffaug"] = {
        "ms_per_step": ms, "unaugmented_ms_per_step": wgan_ms,
        "phase_ms": phases, "max_memory_bytes": mem, "losses": losses,
        "k1_launches": k1, "k2_launches": k2}
    del tr, state, images, videos
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase("one ADA + R1 mnist_ode step at reduced width (ngf=ndf=8, B=4, p "
          "carried in at 0.5 and 0.3): card vs CPU float64")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        err_loss, err_nets, cpu_loss, cpu_nets, n_tensors = card_vs_cpu_step(
            dev, get_config("mnist_ode", ngf=8, ndf=8, batch_size=4,
                            ada_step=0.05, **ADA_RUN),
            ada={"p_img": 0.5, "p_vid": 0.3})
    finally:
        torch.backends.cudnn.deterministic = False
    say(f"ADA + R1 train_step vs the CPU's float64 step: card (float32, TF32 "
        f"off, cuDNN deterministic) losses, rt and p max|diff| "
        f"{err_loss:.3e}, parameters, statistics and Adam moments max|diff| "
        f"{err_nets:.3e} over {n_tensors} tensors (tol {TOL_STEP}); the CPU's "
        f"float32 step {cpu_loss:.3e} and {cpu_nets:.3e}; "
        f"{time.perf_counter() - t0:.1f} s")
    require(err_loss < TOL_STEP and err_nets < TOL_STEP,
            f"ADA card vs CPU: losses {err_loss}, nets {err_nets}")
    out["ada_card_vs_cpu_max_abs"] = {
        "losses_rt_p": err_loss, "nets": err_nets,
        "cpu_float32_losses_rt_p": cpu_loss, "cpu_float32_nets": cpu_nets}

    t0 = time.perf_counter()
    phase("the loop closed: python -m ganode_tpu_torch.train (ADA options, "
          "EMA, 2 steps) then python -m ganode_tpu_torch.generate --workdir "
          "--out --gif")
    torch.backends.cudnn.allow_tf32 = True
    sets = [f"{k}={v}" for k, v in ADA_RUN.items()] + ["ema_decay=0.999"]
    set_args = [a for s in sets for a in ("--set", s)]
    tmp = tempfile.mkdtemp(prefix="ganode_loop_")
    try:
        wd = os.path.join(tmp, "run")
        npz, gif = os.path.join(tmp, "v.npz"), os.path.join(tmp, "g.gif")
        run_child([sys.executable, "-m", "ganode_tpu_torch.train", "--config",
                   "mnist_ode", "--synthetic", "--steps", "2", "--workdir", wd,
                   "--set", "log_every=1"] + set_args,
                  "the training CLI with ADA")
        lines = jsonl(os.path.join(wd, "metrics.jsonl"))
        require([l["step"] for l in lines] == [0, 1] and all(
            math.isfinite(l[k]) for l in lines for k in
            ("gen_loss", "rt_img", "rt_vid", "ada_p_img", "ada_p_vid")),
            f"ADA metrics.jsonl: {lines}")
        printed = run_child(
            [sys.executable, "-m", "ganode_tpu_torch.generate", "--config",
             "mnist_ode", "--workdir", wd, "--num", "16", "--out", npz,
             "--gif", gif] + set_args, "the generate CLI on the workdir")
        require("restored step 2" in printed, f"generate printed {printed}")
        videos = np.load(npz)["videos"]
        cfg = get_config("mnist_ode", **ADA_RUN, ema_decay=0.999)
        tr = build_trainer(cfg, device=dev)
        state = CheckpointManager(os.path.join(wd, "checkpoints")).restore(
            tr.init_state())
        require(state.step == 2 and state.ema_params is not None
                and state.ada is not None, "the restored state")
        sess = GeneratorSession(tr.gen, tr.eval_gen_variables(state), seed=0,
                                device=dev)
        want = layout.video_from_torch(sess.sample_videos(16)[0]).cpu().numpy()
        err = float(np.abs(videos - want).max())
        frames = gifs.read_gif(gif)
        grid = np.repeat(gifs.video_grid(videos, 4), 3, axis=-1)
        require(videos.shape == (16, 16, 28, 28, 1) and err <= TOL_CROSS_PROCESS,
                f"served videos {videos.shape}, {err} from GeneratorSession")
        require(frames.shape == grid.shape and np.array_equal(frames, grid),
                f"GIF {frames.shape} does not decode to the 4x4 grid")
        seconds = time.perf_counter() - t0
        say(f"loop: trained 2 ADA steps with EMA and served the workdir's step "
            f"2 through the CLI: {videos.shape} videos, max|diff| {err:.1e} "
            f"from GeneratorSession on eval_gen_variables (the EMA weights); "
            f"GIF {os.path.getsize(gif)} bytes decoded by utils/gifs.read_gif "
            f"to its {frames.shape} grid exactly; p after 2 steps "
            f"{ {k: v.item() for k, v in state.ada.items()} }; {seconds:.1f} "
            f"s; {card}")
        out["loop"] = {"seconds": seconds, "max_abs_vs_session": err,
                       "gif_bytes": os.path.getsize(gif)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def leaky_relu_phase(dev, card) -> dict:
    """Phase 31 (module docstring); returns the record's entry."""
    import torch
    import torch.nn.functional as F

    import ganode_tpu_torch.models.mocogan as mocogan
    from ganode_tpu_torch.train import build_trainer
    from ganode_tpu_torch.utils.config import get_config

    t0 = time.perf_counter()
    phase("the leaky_relu repair's cost: ucf_ode and ucf_wgan_gp_128 steps "
          "with flax's derivative at 0 and with F.leaky_relu, in turns")
    torch.backends.cudnn.allow_tf32 = True
    flax_like = mocogan.leaky_relu
    fused = lambda x, negative_slope=0.2: F.leaky_relu(x, negative_slope)
    out = {}
    # the warm-up steps precede the first turn only: the later turns run
    # on a warm process
    for name, warmup, n in (("ucf_ode", 2, 5), ("ucf_wgan_gp_128", 1, 1)):
        cfg = get_config(name)
        tr = build_trainer(cfg, device=dev)
        state = tr.init_state()
        gt = torch.Generator(dev).manual_seed(0)
        images, videos = random_batches(cfg, dev, 0)
        runs = {"flax": [], "fused": []}
        try:
            for turn, which in enumerate(("flax", "fused", "fused", "flax")):
                mocogan.leaky_relu = flax_like if which == "flax" else fused
                runs[which].append(timed_steps(
                    tr, state, images, videos, gt, warmup if turn == 0 else 0,
                    n)[0])
        finally:
            mocogan.leaky_relu = flax_like
        out[name] = runs
        mean = {k: sum(v) / len(v) for k, v in runs.items()}
        say(f"{name} train_step, leaky_relu with flax's derivative at 0 "
            f"{' / '.join(f'{m:.3f}' for m in runs['flax'])} ms against "
            f"F.leaky_relu {' / '.join(f'{m:.3f}' for m in runs['fused'])} "
            f"(turns flax, fused, fused, flax; {n} steps each, {warmup} "
            f"warm-up before the first): {100 * (mean['flax'] / mean['fused'] - 1):+.2f} %; "
            f"{card}")
        del tr, state, images, videos
        torch.cuda.empty_cache()
    say(f"leaky_relu phase: {time.perf_counter() - t0:.1f} s")
    return out


GRES = ("ucf_gres", "ucf_odegres")
GRES_STEPS = 3    # timed full-width steps after one warm-up (phase 32)
# The float32 GRes step against float64 (phase 33), fixed bars per part of
# each net (its parameters, its buffers, each Adam moment): |diff| <=
# F32_RTOL |ref| + F32_FLOOR * the part's largest magnitude, as the CPU step
# tests hold float64; the Adam moments get F32_MOMENTS * that magnitude and
# the parameters 2 * lr more. Measured on the CPU over 13 seeds at the
# tests' width (tests/gres_float32_drift.py, PERF.md §6): 1-9 of the
# generator trunk's ReLU inputs per call change sign between float32 and
# float64, which moves the generator's Adam moments by up to 3.8e-2 of the
# part's largest magnitude in JAX's own float32 step (1.9e-2 in the
# port's) and the critics' by up to 3.4e-3 (2.5e-3); Adam turns the
# rounding noise of exactly-zero gradients (conv biases that feed a
# batch-statistics norm) into parameter steps of up to lr either way.
F32_RTOL, F32_FLOOR, F32_MOMENTS = 1e-4, 1e-5, 5e-2


def spectral_buffers(module) -> dict:
    """Every power-iteration state of ``module`` by name: each ``SNConv``'s
    ``u`` and each ODE block's ``u0``/``u1``."""
    return {k: v for k, v in module.named_buffers()
            if k.rsplit(".", 1)[-1] in ("u", "u0", "u1")}


def f32_step_misses(s_card, s_ref, params, lr) -> tuple:
    """The float32 card step's tensors against the float64 reference's, by
    the fixed bars above (``params``: the names of the nets' parameters) ->
    (the worst |diff| over its bar per part, the tensors over their bar)."""
    def part(key):
        net, rest = key.split(".", 1)
        if rest.startswith("adam."):
            return net, rest.rsplit(".", 1)[1]
        return net, "params" if key in params else "buffers"

    parts = {}
    for k in s_ref:
        parts.setdefault(part(k), []).append(k)
    worst, misses = {}, []
    for (net, kind), keys in parts.items():
        scale = max(s_ref[k].abs().max().item() for k in keys)
        atol = F32_FLOOR * scale
        if kind.startswith("exp_avg"):
            atol = F32_MOMENTS * scale
        elif kind == "params":
            atol += 2 * lr
        ratio = 0.0
        for k in keys:
            over = ((s_card[k] - s_ref[k]).abs()
                    / (F32_RTOL * s_ref[k].abs() + atol)).max().item()
            ratio = max(ratio, over)
            if over > 1:
                misses.append((k, over))
        worst[f"{net}.{kind}"] = ratio
    return worst, misses


def gres_phases(dev, card, events_ms) -> dict:
    """Phases 32-34 (module docstring): the GResBlock trunks; returns the
    record's entry."""
    import torch

    from ganode_tpu_torch.compat import GeneratorSession
    from ganode_tpu_torch.models import generator_for_config
    from ganode_tpu_torch.ops import fused_rk4, reference_rk4_motion
    from ganode_tpu_torch.train import build_trainer
    from ganode_tpu_torch.utils.config import get_config

    out = {}
    for name in GRES:
        cfg = get_config(name)
        d = cfg.d_iters
        t0 = time.perf_counter()
        phase(f"train {name} at full width ({cfg.trunk}, ngf=ndf={cfg.ngf}, "
              f"B={cfg.batch_size}, T={cfg.video_length}, 64x64x3, SN critics "
              f"ksize {cfg.video_disc_ksize}, {cfg.loss}, d_iters {d}): 1 "
              f"warm-up + {GRES_STEPS} timed steps, cuDNN TF32 on")
        torch.backends.cudnn.allow_tf32 = True
        tr = build_trainer(cfg, device=dev)
        state = tr.init_state()
        gt = torch.Generator(dev).manual_seed(0)
        images, videos = random_batches(cfg, dev, 0)
        # u advances: every train-mode forward of a generator block (its
        # SNConvs' u, or its u0/u1 and proj_down's u) and of a critic's
        # first SNConv
        advances = {"gen": 0, "dis_img": 0, "dis_vid": 0}

        def count(key, block=True):
            def hook(module, args, kwargs):
                advances[key] += (module.training if block
                                  else bool(kwargs["update_stats"]))
            return hook

        hooks = [tr.gen.main.block_0.register_forward_pre_hook(
            count("gen"), with_kwargs=True)]
        hooks += [getattr(tr, k).SNConv_0.register_forward_pre_hook(
            count(k, False), with_kwargs=True) for k in ("dis_img", "dis_vid")]
        u_start = {k: {n: u.clone() for n, u in spectral_buffers(
            getattr(tr, k)).items()} for k in advances}
        ms, mem, losses, k1, k2, _ = timed_steps(
            tr, state, images, videos, gt, 1, GRES_STEPS)
        # the warm-up step's advances are counted too: GRES_STEPS + 1 steps
        per_step = {k: v / (GRES_STEPS + 1) for k, v in advances.items()}
        for h in hooks:
            h.remove()
        require(k1 == 6 * GRES_STEPS and k2 == 0,
                f"{name}: K1 {k1} / K2 {k2} in {GRES_STEPS} steps, want K1 "
                f"{6 * GRES_STEPS} (rk4 motion) and K2 0")
        require(all(map(math.isfinite, losses.values())), f"losses {losses}")
        want_adv = {"gen": 2 * d + 2, "dis_img": 2 * d + 1,
                    "dis_vid": 2 * d + 1}
        require(per_step == want_adv,
                f"{name}: u advanced {per_step} times per step, want "
                f"{want_adv}")
        norms = {f"{k}.{n}": u.norm().item() for k in advances
                 for n, u in spectral_buffers(getattr(tr, k)).items()}
        require(all(abs(v - 1.0) <= TOL_U_NORM for v in norms.values()),
                f"{name}: u norms {norms}")
        moved = [f"{k}.{n}" for k in advances
                 for n, u in spectral_buffers(getattr(tr, k)).items()
                 if u.numel() > 1 and torch.equal(u, u_start[k][n])]
        require(not moved, f"{name}: u did not move: {moved}")
        phases = phase_ms(tr, state, images, videos, gt, 1)
        flops = step_flops(cfg)
        rec = {"config": name, "batch": cfg.batch_size,
               "frames": cfg.video_length, "d_iters": d, "card": card,
               "ms_per_step": ms, "clips_per_s": cfg.batch_size * 1e3 / ms,
               "phase_ms": phases, "max_memory_bytes": mem,
               "losses": losses, "flops": flops,
               "k1_launches_per_step": k1 / GRES_STEPS,
               "k2_launches": k2, "u_advances_per_step": per_step,
               "u_norm_max_dev": max(abs(v - 1) for v in norms.values())}
        say(f"{name} train_step (cuDNN TF32 on): {ms:.3f} ms/step, "
            f"{cfg.batch_size * 1e3 / ms:.2f} clips/s; phases per step: "
            f"D_img {phases['d_img']:.3f} ms, D_vid {phases['d_vid']:.3f} "
            f"ms, G {phases['g']:.3f} ms; peak memory {mem / 2 ** 30:.2f} "
            f"GiB; {flops['step'] / 1e12:.2f} TFLOP per step counted "
            f"from the shapes (samples {d * flops['samples'] / 1e12:.2f}, G "
            f"update {flops['g_update'] / 1e12:.2f}), so "
            f"{flops['step'] / ms / 1e9:.1f} TFLOP/s over the step and "
            f"{flops['g_update'] / phases['g'] / 1e9:.1f} in G; K1 "
            f"{k1 / GRES_STEPS:g} per step, K2 {k2}; u advances per step "
            f"{per_step}, norms within {rec['u_norm_max_dev']:.1e} of 1; "
            f"losses {losses}; {time.perf_counter() - t0:.1f} s; {card}")
        del tr, state, images, videos
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        phase(f"one {name} step at reduced width (ngf=ndf=8, B=4, T=16, "
              "d_iters 2): card vs CPU float64")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        cfg_r = get_config(name, ngf=8, ndf=8, batch_size=4, video_length=16,
                           d_iters=2)
        try:
            errs = {dt: card_vs_cpu_step(dev, cfg_r, card_dtype=dt,
                                         detail=True)
                    for dt in (torch.float64, torch.float32)}
        finally:
            torch.backends.cudnn.deterministic = False
        f64_loss, f64_nets, _, _, n_tensors, _, _ = errs[torch.float64]
        (err_loss, err_nets, cpu_loss, cpu_nets, _, s_card,
         s_ref) = errs[torch.float32]
        tr_r = build_trainer(cfg_r, device="cpu")
        params = {f"{n}.{k}" for n in ("gen", "dis_img", "dis_vid")
                  for k, _ in getattr(tr_r, n).named_parameters()}
        worst, misses = f32_step_misses(s_card, s_ref, params, cfg_r.lr)
        say(f"{name} train_step vs the CPU's float64 step over {n_tensors} "
            f"tensors (parameters, statistics, u/u0/u1, Adam moments), "
            f"max|diff| of losses / tensors: the card in float64 "
            f"{f64_loss:.3e} / {f64_nets:.3e} (tol {TOL_STEP}); the card in "
            f"float32 (TF32 off, cuDNN deterministic) {err_loss:.3e} / "
            f"{err_nets:.3e} (losses tol {TOL_STEP}; the CPU's float32 step "
            f"{cpu_loss:.3e} / {cpu_nets:.3e}); the card's float32 worst "
            f"|diff| over its fixed bar per part "
            f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } (<= 1); "
            f"{time.perf_counter() - t0:.1f} s")
        require(f64_loss < TOL_STEP and f64_nets < TOL_STEP,
                f"{name} card (float64) vs CPU: losses {f64_loss}, nets "
                f"{f64_nets}")
        require(err_loss < TOL_STEP and not misses,
                f"{name} card (float32) vs CPU float64: losses {err_loss}, "
                f"tensors over their bar {misses[:8]}")
        rec["card_vs_cpu_max_abs"] = {"card_float64_losses": f64_loss,
                                      "card_float64_nets": f64_nets,
                                      "losses": err_loss, "nets": err_nets,
                                      "cpu_float32_losses": cpu_loss,
                                      "cpu_float32_nets": cpu_nets,
                                      "float32_over_bar_by_part": worst}

        t0 = time.perf_counter()
        phase(f"serve {name} at full width: sample_videos(64) through "
              "GeneratorSession, against the plain rk4 motion at the same n")
        sess = GeneratorSession(generator_for_config(cfg, device=dev), seed=0,
                                device=dev)
        gen = sess.gen
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        videos, _ = sess.sample_videos(64)
        torch.cuda.synchronize()
        serve_k1, serve_mem = fused_rk4.launches, torch.cuda.max_memory_allocated()
        require(serve_k1 == 1, f"{name}: {serve_k1} K1 launches serving")
        require(tuple(videos.shape) == (64, 3, 16, 64, 64)
                and bool(torch.isfinite(videos).all())
                and videos.abs().max().item() <= 1.0,
                f"{name}: served {tuple(videos.shape)}, not finite in [-1, 1]")
        torch.backends.cudnn.allow_tf32 = False
        g = torch.Generator().manual_seed(5)
        zc = torch.randn((64, cfg.dim_z_content), generator=g).to(dev)
        x0 = torch.randn((64, cfg.dim_z_motion), generator=g).to(dev)
        with torch.no_grad():
            v_k, _ = gen.sample_videos(64, z_content=zc, x0=x0)
            m = gen.motion
            l0, l1 = m.ode_fn.Dense_0, m.ode_fn.Dense_1
            zs = reference_rk4_motion(
                m.WarmupMLP_0(x0), l0.weight.t(), l0.bias, l1.weight.t(),
                l1.bias, torch.linspace(0.0, 1.0, 16)).transpose(0, 1)
            # every frame of the 64 clips in one trunk call, as the sampler
            z = torch.cat([zc.repeat_interleave(16, 0),
                           zs.reshape(64 * 16, -1)], 1)
            v_p = gen.main(z).reshape(64, 16, 3, 64, 64).permute(
                0, 1, 3, 4, 2)
        err = (v_k - v_p).abs().max().item()
        require(err < TOL_VIDEO, f"{name}: served videos vs the plain motion "
                f"{err}")
        torch.backends.cudnn.allow_tf32 = True
        n = 5 if name == "ucf_gres" else 3
        serve_ms = events_ms(lambda: sess.sample_videos(64), n)
        with torch.no_grad():
            trunk_ms = events_ms(lambda: gen.main(z), n)
        say(f"{name} sample_videos(64): {serve_ms:.3f} ms per call, "
            f"{64e3 / serve_ms:.1f} clips/s, the trunk alone (1024 frames) "
            f"{trunk_ms:.3f} ms (cuDNN TF32 on); peak memory "
            f"{serve_mem / 2 ** 30:.2f} GiB; K1 {serve_k1} per call; kernel "
            f"path vs plain motion max|diff| {err:.3e} (tol {TOL_VIDEO}, "
            f"TF32 off); {time.perf_counter() - t0:.1f} s; {card}")
        rec["serving"] = {"ms": serve_ms, "trunk_ms": trunk_ms,
                          "max_memory_bytes": serve_mem,
                          "k1_launches": serve_k1,
                          "vs_plain_motion_max_abs": err}
        out[name] = rec
        del sess, gen, videos, v_k, v_p, z, zs
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The ODE-GAN trainer (phases 35-38): ``train/odegan.py`` is plain tensor
# code over ``torch.autograd.grad``, as JAX's is plain ``jax.grad``; its
# discriminator regularizer differentiates a gradient through the generator,
# so K1's and K2's ``Function``s are differentiated twice.
# ---------------------------------------------------------------------------

ODEGAN_METHODS = ("euler", "rk2", "rk4")
ODEGAN_NETS = ("dis_img", "dis_vid", "gen")
# K1 launches per network step: one per sample_videos and sample_images,
# i.e. 2 for the penalty's G loss (a D step with reg > 0), then per stage 1
# for a D loss and 2 for the G loss
ODEGAN_K1 = {"euler": {"dis_img": 3, "dis_vid": 3, "gen": 2},
             "rk2": {"dis_img": 4, "dis_vid": 4, "gen": 4},
             "rk4": {"dis_img": 6, "dis_vid": 6, "gen": 8}}
ODEGAN_LR, ODEGAN_REG = 0.02, 0.01
ODEGAN_TRIPLES = 3   # timed rk4 triples after one warm-up (phase 36)
ODEGAN_CLI_STEPS = 3
# d/dθ <VJP(g), v> through a kernel's Function against the plain
# recurrence: max |diff| over the tensor's largest magnitude
TOL_DOUBLE_BACKWARD = 1e-5


def double_backward_err(module, fused, plain, inputs, consts, variant):
    """``d/d(inputs, g) <VJP(g), v>`` for random float32 ``g`` and ``v``,
    through ``fused`` (the kernel's wrapper, its launch forced to
    ``variant``) and through ``plain`` on the same inputs -> (the worst
    tensor's max |diff| over its largest magnitude, launches of
    ``variant``)."""
    import functools

    import torch

    gen = torch.Generator(inputs[0].device).manual_seed(3)
    with torch.no_grad():
        shape = plain(*inputs, *consts).shape
    cot0 = torch.randn(shape, generator=gen, device=inputs[0].device)
    vs = [torch.randn(a.shape, generator=gen, device=a.device) for a in inputs]
    launch, before = module._launch, module.launches_by_variant[variant]
    module._launch = functools.partial(launch, variant=variant)
    try:
        results = []
        for fn in (fused, plain):
            leaves = [a.detach().clone().requires_grad_() for a in inputs]
            cot = cot0.clone().requires_grad_()
            vjp = torch.autograd.grad(fn(*leaves, *consts), leaves, cot,
                                      create_graph=True)
            s = sum((a * b).sum() for a, b in zip(vjp, vs))
            got = torch.autograd.grad(s, leaves + [cot], allow_unused=True)
            results.append([torch.zeros_like(x) if d is None else d
                            for x, d in zip(leaves + [cot], got)])
    finally:
        module._launch = launch
    err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
              for a, b in zip(*results))
    return err, module.launches_by_variant[variant] - before


def odegan_noise(gen, n: int, model: str, generator) -> dict:
    """An rk4 step's draws of ``n`` samples for ``model`` from
    ``generator`` (on its device): the penalty's video and image for a D
    step, then each stage's (a G stage a video and an image, a D stage its
    own kind)."""
    draw = lambda what: gen.draw_noise(n, what, generator)
    noise = {}
    if model != "gen":
        noise["penalty"] = {"videos": draw("videos"), "images": draw("images")}
    kinds = {"gen": ("videos", "images"), "dis_img": ("images",),
             "dis_vid": ("videos",)}[model]
    for stage in range(4):
        noise[stage] = {what: draw(what) for what in kinds}
    return noise


def odegan_reduced_run(mods_cpu, b, real, noises, device, dtype) -> dict:
    """One rk4 triple (dis_img, dis_vid, gen) of the ODE-GAN over copies of
    the CPU modules ``mods_cpu`` (``b`` samples a batch) moved to ``device`` and ``dtype``, on the
    real batches ``real`` and the draws ``noises`` (per network) cast alike
    -> every net's parameters after each step and the penalty gradient of
    each D step, by name, as float64 CPU tensors. float64 runs the plain
    rk4 motion (K1's wrapper takes float32 only)."""
    import torch

    import ganode_tpu_torch.models.motion as motion_mod
    from ganode_tpu_torch.ops import fused_rk4_motion, reference_rk4_motion
    from ganode_tpu_torch.train import (ODEGANTrainer,
                                        discriminator_regularizer,
                                        make_mocogan_losses, module_params)

    mods = {n: copy.deepcopy(m).to(device, dtype) for n, m in mods_cpu.items()}
    losses = make_mocogan_losses(mods["gen"], mods["dis_img"], mods["dis_vid"],
                                 b)
    tr = ODEGANTrainer(*losses, lr=ODEGAN_LR, reg=ODEGAN_REG, method="rk4")
    move = lambda d: {k: move(v) if isinstance(v, dict) else
                      v.to(device, dtype) if v.is_floating_point() else
                      v.to(device) for k, v in d.items()}
    params = {n: module_params(m) for n, m in mods.items()}
    out = {}
    if dtype == torch.float64:
        motion_mod.fused_rk4_motion = reference_rk4_motion
    try:
        for model in ODEGAN_NETS:
            noise = move(noises[model])
            batch = None if model == "gen" else real[model].to(device, dtype)
            if model != "gen":
                gp = discriminator_regularizer(
                    lambda g_p, d_p: losses[0](
                        {**params, "gen": g_p, model: d_p},
                        noise["penalty"], None),
                    params["gen"], params[model])
                out.update({f"{model}.penalty.{k}": v for k, v in gp.items()})
            params = tr.step(params, noise, batch, model=model)
            out.update({f"{model}.after.{n}.{k}": v for n in params
                        for k, v in params[n].items()})
    finally:
        motion_mod.fused_rk4_motion = fused_rk4_motion
    return {k: v.detach().cpu().double() for k, v in out.items()}


def odegan_misses(got, ref) -> tuple:
    """The float32 run's tensors against float64's, by the fixed bars of
    phase 33 per part (a step's net's parameters, a penalty gradient):
    |diff| <= F32_RTOL |ref| + F32_FLOOR * the part's largest magnitude ->
    (the worst |diff| over its bar per part, the tensors over their bar)."""
    parts = {}
    for k in ref:
        step, kind, rest = k.split(".", 2)
        part = f"{step}.{kind}" + (f".{rest.split('.', 1)[0]}"
                                   if kind == "after" else "")
        parts.setdefault(part, []).append(k)
    worst, misses = {}, []
    for part, keys in parts.items():
        atol = F32_FLOOR * max(ref[k].abs().max().item() for k in keys)
        ratio = 0.0
        for k in keys:
            over = ((got[k] - ref[k]).abs()
                    / (F32_RTOL * ref[k].abs() + atol)).max().item()
            ratio = max(ratio, over)
            if over > 1:
                misses.append((k, over))
        worst[part] = ratio
    return worst, misses


def odegan_phases(dev, card, events_ms) -> dict:
    """Phases 35-38 (module docstring): the ODE-GAN trainer; returns the
    record's entry."""
    import torch

    from ganode_tpu_torch.models import (discriminators_for_config,
                                         generator_for_config)
    from ganode_tpu_torch.ops import (fused_gru, fused_gru_motion, fused_rk4,
                                      fused_rk4_motion, reference_gru_motion,
                                      reference_rk4_motion)
    from ganode_tpu_torch.train import (ODEGANTrainer,
                                        discriminator_regularizer,
                                        make_mocogan_losses, module_params)
    from ganode_tpu_torch.utils.config import get_config

    out = {}
    t0 = time.perf_counter()
    phase("K1 and K2 double backward (d/dθ <VJP(g), v>) against the plain "
          "recurrences: ucf_ode's motion (B=32, D=H=16, T=16) and "
          "mnist_gru's (B=32, D=16, T=16), warp and wide")
    g = torch.Generator().manual_seed(5)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to(dev)
    ts = torch.linspace(0.0, 1.0, 16)
    rk4_in = [r(32, 16), r(16, 16, scale=0.4), r(16, scale=0.1),
              r(16, 16, scale=0.4), r(16, scale=0.1)]
    gru_in = [r(32, 16), r(16, 32, 16), r(16, 48, scale=0.3),
              r(16, 48, scale=0.3), r(48, scale=0.1), r(48, scale=0.1)]
    dbl = {}
    for kernel, module, fused, plain, inputs, consts in (
            ("K1 rk4_motion", fused_rk4, fused_rk4_motion,
             reference_rk4_motion, rk4_in, (ts,)),
            ("K2 gru_motion", fused_gru, fused_gru_motion,
             reference_gru_motion, gru_in, ())):
        for variant in ("warp", "wide"):
            err, n = double_backward_err(module, fused, plain, inputs, consts,
                                         variant)
            dbl[f"{kernel} {variant}"] = err
            say(f"{kernel} {variant}: double backward max|Function-plain| / "
                f"max|plain| = {err:.3e} (tol {TOL_DOUBLE_BACKWARD}); "
                f"{n} launch")
            require(n == 1 and err < TOL_DOUBLE_BACKWARD,
                    f"{kernel} {variant} double backward: {err}, {n} launches")
    out["double_backward_err"] = dbl
    say(f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cfg = get_config("ucf_ode")
    b = cfg.batch_size
    phase(f"ODE-GAN over the ucf_ode triple at full width ({cfg.trunk}, "
          f"ngf=ndf={cfg.ngf}, B={b}, T={cfg.video_length}, 64x64x3, "
          f"PatchImageDiscriminator, VideoDiscriminator(ksize="
          f"{cfg.video_disc_ksize}), eval mode, BCE, lr {ODEGAN_LR}, reg "
          f"{ODEGAN_REG}), cuDNN TF32 on: a dis_img, dis_vid and gen step "
          f"of each method, then {ODEGAN_TRIPLES} timed rk4 triples")
    torch.backends.cudnn.allow_tf32 = True
    gen = generator_for_config(cfg, device=dev)
    dis_img, dis_vid = discriminators_for_config(cfg, device=dev)
    mods = {"gen": gen, "dis_img": dis_img, "dis_vid": dis_vid}
    losses = make_mocogan_losses(gen, dis_img, dis_vid, b)
    params0 = {n: module_params(m) for n, m in mods.items()}
    images, videos = random_batches(cfg, dev, 0)
    batches = {"dis_img": images[0], "dis_vid": videos[0], "gen": None}
    rng = torch.Generator(dev).manual_seed(0)

    def triple(tr, params):
        """One step of each net in turn -> (params, ms and K1 launches per
        network step, K2 launches)."""
        ms, k1, k2 = {}, {}, 0
        for model in ODEGAN_NETS:
            reset_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            new = tr.step(params, rng, batches[model], model=model)
            ev[1].record()
            torch.cuda.synchronize()
            ms[model] = ev[0].elapsed_time(ev[1])
            k1[model], k2 = fused_rk4.launches, k2 + fused_gru.launches
            moved = [n for n in mods if any(
                not torch.equal(new[n][k], params[n][k]) for k in params[n])]
            require(moved == [model], f"a {model} step moved {moved}")
            require(all(bool(torch.isfinite(v).all())
                        for v in new[model].values()),
                    f"{model}: parameters not finite")
            params = new
        return params, ms, k1, k2

    def loss_values(params):
        with torch.no_grad():
            return {"g_loss": losses[0](params, rng, None).item(),
                    "d_img_loss": losses[1](params, rng, images[0]).item(),
                    "d_vid_loss": losses[2](params, rng, videos[0]).item()}

    for method in ODEGAN_METHODS:
        tr = ODEGANTrainer(*losses, lr=ODEGAN_LR, reg=ODEGAN_REG,
                           method=method)
        torch.cuda.reset_peak_memory_stats()
        params, ms, k1, k2 = triple(tr, params0)
        vals = loss_values(params)
        require(k1 == ODEGAN_K1[method] and k2 == 0,
                f"{method}: K1 {k1} per network step, K2 {k2}; want "
                f"{ODEGAN_K1[method]} and 0")
        require(all(map(math.isfinite, vals.values())), f"losses {vals}")
        out[method] = {"ms_first": ms, "k1_launches": k1, "k2_launches": k2,
                       "losses_after": vals,
                       "max_memory_bytes": torch.cuda.max_memory_allocated()}
        say(f"ODE-GAN {method}: first triple (the first cold) ms per network step "
            f"{ {k: round(v, 2) for k, v in ms.items()} }; K1 launches "
            f"{k1}, K2 {k2}; losses after {vals}; peak memory "
            f"{out[method]['max_memory_bytes'] / 2 ** 30:.2f} GiB; {card}")
    tr = ODEGANTrainer(*losses, lr=ODEGAN_LR, reg=ODEGAN_REG, method="rk4")
    torch.cuda.reset_peak_memory_stats()
    timed, params = [], params0
    for _ in range(ODEGAN_TRIPLES):
        params, ms, k1, k2 = triple(tr, params)
        require(k1 == ODEGAN_K1["rk4"] and k2 == 0, f"rk4: K1 {k1}, K2 {k2}")
        timed.append(ms)
    mem = torch.cuda.max_memory_allocated()
    ms = {k: sum(t[k] for t in timed) / len(timed) for k in ODEGAN_NETS}
    reg_ms = {}
    for net in ("dis_img", "dis_vid"):
        def penalty(net=net):
            return discriminator_regularizer(
                lambda g_p, d_p: losses[0]({**params, "gen": g_p, net: d_p},
                                           rng, None),
                params["gen"], params[net])
        reg_ms[net] = events_ms(penalty, 3)
    out["rk4_timed"] = {"ms_per_network_step": ms, "triples": timed,
                        "regularizer_ms": reg_ms, "max_memory_bytes": mem,
                        "k1_launches_per_network_step": ODEGAN_K1["rk4"],
                        "losses_after": loss_values(params)}
    say(f"ODE-GAN rk4 (cuDNN TF32 on, matmul TF32 off), mean of "
        f"{ODEGAN_TRIPLES} triples after the warm-up: dis_img "
        f"{ms['dis_img']:.2f} ms, dis_vid {ms['dis_vid']:.2f} ms, gen "
        f"{ms['gen']:.2f} ms per network step ({sum(ms.values()):.2f} per "
        f"triple); the regularizer alone {reg_ms['dis_img']:.2f} ms "
        f"(dis_img) and {reg_ms['dis_vid']:.2f} ms (dis_vid); peak memory "
        f"{mem / 2 ** 30:.2f} GiB; K1 {ODEGAN_K1['rk4']} per network step; "
        f"{time.perf_counter() - t0:.1f} s; {card}")
    del params, params0, mods, losses, gen, dis_img, dis_vid, images, videos
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase("one ODE-GAN rk4 triple at reduced width (ngf=ndf=8, B=4, T=16, "
          f"reg {ODEGAN_REG}): the card in float64 and in float32 (K1) "
          "against the CPU in float64, cuDNN deterministic, TF32 off")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg_r = get_config("ucf_ode", ngf=8, ndf=8, batch_size=4,
                       video_length=16)
    mods_cpu = {"gen": generator_for_config(cfg_r, device="cpu")}
    mods_cpu["dis_img"], mods_cpu["dis_vid"] = discriminators_for_config(
        cfg_r, device="cpu")
    # running statistics away from the init's zeros and ones, so that a
    # side using other statistics would show
    gs = torch.Generator().manual_seed(11)
    for m in mods_cpu.values():
        for k, buf in m.named_buffers():
            if k.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gs))
            elif k.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gs))
    ims, vids = random_batches(cfg_r, "cpu", 7)
    real = {"dis_img": ims[0], "dis_vid": vids[0]}
    gn = torch.Generator().manual_seed(8)
    noises = {m: odegan_noise(mods_cpu["gen"], 4, m, gn) for m in ODEGAN_NETS}
    try:
        ref = odegan_reduced_run(mods_cpu, 4, real, noises, "cpu", torch.float64)
        card64 = odegan_reduced_run(mods_cpu, 4, real, noises, dev,
                                    torch.float64)
        reset_counts()
        card32 = odegan_reduced_run(mods_cpu, 4, real, noises, dev,
                                    torch.float32)
        k1_reduced = fused_rk4.launches
    finally:
        torch.backends.cudnn.deterministic = False
    f64_err = max((card64[k] - v).abs().max().item() for k, v in ref.items())
    worst, misses = odegan_misses(card32, ref)
    f32_err = max((card32[k] - v).abs().max().item() for k, v in ref.items())
    say(f"ODE-GAN reduced rk4 triple over {len(ref)} tensors (each net's "
        f"parameters after each step, each D step's penalty gradient): the "
        f"card in float64 max|diff| {f64_err:.3e} (tol {TOL_STEP}); in "
        f"float32 with K1 ({k1_reduced} launches) {f32_err:.3e}, worst "
        f"|diff| over its fixed bar per part "
        f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } (<= 1); "
        f"{time.perf_counter() - t0:.1f} s")
    require(f64_err < TOL_STEP, f"ODE-GAN card float64 vs CPU: {f64_err}")
    # the triple's launches, and 2 more for each D step's penalty gradient
    # taken on its own
    require(k1_reduced == sum(ODEGAN_K1["rk4"].values()) + 4 and not misses,
            f"ODE-GAN card float32 vs CPU float64: K1 {k1_reduced}, tensors "
            f"over their bar {misses[:8]}")
    out["reduced_card_vs_cpu"] = {"card_float64_max_abs": f64_err,
                                  "card_float32_max_abs": f32_err,
                                  "float32_over_bar_by_part": worst,
                                  "k1_launches": k1_reduced}

    t0 = time.perf_counter()
    phase("the ODE-GAN CLI: python -m ganode_tpu_torch.train_odegan "
          f"--synthetic, --arch mlp for adam, euler, rk2 and rk4 "
          f"({ODEGAN_CLI_STEPS} steps, B=64) and --arch dcgan --method euler "
          "--dry-run, five child processes at once")
    tmp = tempfile.mkdtemp(prefix="ganode_odegan_")
    cli = {}
    try:
        runs = [("mlp", m, ["--steps", str(ODEGAN_CLI_STEPS)])
                for m in ("adam", "euler", "rk2", "rk4")]
        runs.append(("dcgan", "euler", ["--dry-run"]))
        done = run_children([
            ([sys.executable, "-m", "ganode_tpu_torch.train_odegan",
              "--synthetic", "--arch", arch, "--method", method, "--workdir",
              os.path.join(tmp, f"{arch}_{method}")] + extra,
             f"train_odegan --arch {arch} --method {method}")
            for arch, method, extra in runs])
        for (arch, method, extra), (stdout, seconds) in zip(runs, done):
            wd = os.path.join(tmp, f"{arch}_{method}")
            with open(os.path.join(wd, f"losses_{method}.json")) as f:
                logged = json.load(f)
            require([sorted(e) for e in logged] == [["d_loss", "g_loss", "step"]]
                     and logged[0]["step"] == 0
                     and all(math.isfinite(e[k]) for e in logged
                             for k in ("g_loss", "d_loss")),
                     f"losses_{method}.json: {logged}")
            # "... (the first, with its one-time set-up, X ms[; the N after
            # the first Y ms/step]; ...)"
            timing = stdout.split("(the first, with its one-time set-up, ")[1]
            first_ms = float(timing.split(" ms")[0])
            ms_step = (float(timing.split("after the first ")[1]
                             .split(" ms/step")[0])
                       if "after the first" in timing else None)
            cli[f"{arch} {method}"] = {"first_step_ms": first_ms,
                                       "ms_per_later_step": ms_step,
                                       "seconds": seconds, "losses": logged}
            say(f"train_odegan --arch {arch} --method {method}: exit 0 "
                f"{seconds:.1f} s after the five started together; the first "
                f"step {first_ms:.2f} ms, later steps {ms_step} ms/step (its "
                f"own clock, synced, beside the other four); losses "
                f"{logged}; {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["cli"] = cli
    return out


# ---------------------------------------------------------------------------
# Evaluation (phases 39-40): ``eval/`` is cuDNN convolutions and host numpy,
# as the JAX package's is plain XLA and host numpy. The feature models are
# trained here, as the evaluate command does when an asset is absent, so
# the script needs no ``eval_assets/``.
# ---------------------------------------------------------------------------

# the north-star protocol (scripts/diag_raw_vs_ema.py): 512 synthetic reals
# of 128x128x32, 256 fakes from 4 x sample_videos(64), the embedder at
# batch 32
EVAL_REALS, EVAL_FAKES, EVAL_CHUNK, EVAL_EMB_BS = 512, 256, 64, 32
EVAL_STEPS = 20      # feature-model training steps on the card
EVAL_CHECK_CLIPS = 8
# features and probabilities, card (float32, TF32 off, cuDNN deterministic)
# against the CPU in float64: max |diff| over the largest magnitude
TOL_EVAL = 1e-4
# the evaluate command (phase 40): fakes sampled in 64-clip chunks
EVAL_CLI_SAMPLES = 256
JAX_EVAL_KEYS = ["config", "checkpoint_step", "n_samples", "n_fake_videos",
                 "frame_sampling", "asset_hashes", "classifier_train_acc",
                 "embedder_train_acc", "inception_score_mean",
                 "inception_score_std", "fvd"]


def eval_check(model, params, x, run) -> float:
    """``run(model, params, x)`` on the card, float32 with TF32 off and
    cuDNN deterministic, against the same on the CPU in float64: max |diff|
    over the largest magnitude."""
    import torch

    tf32, det = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
    try:
        got = run(model, params, x).double().cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = tf32, det
    cpu = copy.deepcopy(model).cpu().double()
    want = run(cpu, {k: v.detach().cpu().double() for k, v in params.items()},
               x.detach().cpu().double())
    return float((got - want).abs().max() / want.abs().max())


def eval_phases(dev, card) -> dict:
    """Phases 39-40 (module docstring): evaluation at the north-star
    geometry and the evaluate command; returns the record's entry."""
    import torch

    from ganode_tpu_torch import evaluate
    from ganode_tpu_torch.data import synthetic_moving_shapes
    from ganode_tpu_torch.eval import (apply, embed_videos, feature_stats,
                                       frechet_distance, inception_score,
                                       train_classifier, train_video_embedder)
    from ganode_tpu_torch.models import generator_for_config
    from ganode_tpu_torch.ops import fused_gru, fused_rk4
    from ganode_tpu_torch.train import runner
    from ganode_tpu_torch.utils.config import get_config

    out = {}
    t0 = time.perf_counter()
    cfg = get_config("ucf_wgan_gp_128")
    t = cfg.video_length
    phase(f"evaluation at the north-star geometry: synthetic_moving_shapes("
          f"{EVAL_REALS}, {t}, size=128) on the card, the FVD embedder and "
          f"the IS classifier trained {EVAL_STEPS} steps, {EVAL_FAKES} fakes "
          f"of a seeded full-width ucf_wgan_gp_128 generator in "
          f"{EVAL_FAKES // EVAL_CHUNK} x sample_videos({EVAL_CHUNK}), "
          f"embedded at batch {EVAL_EMB_BS}, FVD and IS; cuDNN TF32 on")
    torch.backends.cudnn.allow_tf32 = True
    videos_np, labels_np = synthetic_moving_shapes(EVAL_REALS, t, size=128)
    videos = torch.from_numpy(videos_np).to(dev)
    labels = torch.from_numpy(labels_np).to(dev)
    del videos_np
    frame_ix = torch.randint(0, t, (EVAL_REALS,),
                             generator=torch.Generator().manual_seed(0))
    frames = videos[torch.arange(EVAL_REALS), frame_ix.to(dev)]
    t1 = time.perf_counter()
    embedder, emb_params, emb_acc = train_video_embedder(
        videos, labels, n_classes=64, feature_dim=128, steps=EVAL_STEPS,
        batch_size=16, device=dev)
    classifier, cls_params, cls_acc = train_classifier(
        frames, labels % 8, n_classes=8, steps=EVAL_STEPS, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    say(f"reals {tuple(videos.shape)} ({videos.numel() * 4 / 1e9:.2f} GB) on "
        f"the card; embedder and classifier trained {EVAL_STEPS} steps each "
        f"in {train_s:.1f} s (accuracy {emb_acc:.3f}, {cls_acc:.3f})")
    feat_err = eval_check(embedder, emb_params, videos[:EVAL_CHECK_CLIPS],
                          lambda m, p, v: embed_videos(m, p, v, EVAL_CHECK_CLIPS))
    prob_err = eval_check(classifier, cls_params, frames[:64],
                          lambda m, p, v: torch.softmax(apply(m, p, v), -1))
    say(f"card vs CPU float64 (TF32 off, cuDNN deterministic): embedder "
        f"features of {EVAL_CHECK_CLIPS} clips {feat_err:.3e}, classifier "
        f"probabilities of 64 frames {prob_err:.3e} (max |diff| / max; tol "
        f"{TOL_EVAL})")
    require(feat_err < TOL_EVAL and prob_err < TOL_EVAL,
            f"eval nets card vs CPU: {feat_err}, {prob_err}")

    gen = generator_for_config(cfg, device=dev).eval()
    g = torch.Generator(dev).manual_seed(0)
    # one warm-up pass of every call below (cuDNN's algorithm choice, the
    # dopri5 solver's first call, LAPACK's), then the timed, counted eval
    with torch.no_grad():
        warm = gen.sample_videos(EVAL_CHUNK, generator=g)[0]
    frechet_distance(*feature_stats(embed_videos(
        embedder, emb_params, warm[:EVAL_EMB_BS], EVAL_EMB_BS)),
        *feature_stats(embed_videos(embedder, emb_params,
                                    videos[:EVAL_EMB_BS], EVAL_EMB_BS)))
    apply(classifier, cls_params, warm[:, 0])
    del warm
    g = torch.Generator(dev).manual_seed(0)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    ev = lambda: torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t_eval = time.perf_counter()
    fakes, sample_ms = [], []
    with torch.no_grad():
        for _ in range(EVAL_FAKES // EVAL_CHUNK):
            a, b = ev(), ev()
            a.record()
            fakes.append(gen.sample_videos(EVAL_CHUNK, generator=g)[0])
            b.record()
            torch.cuda.synchronize()
            sample_ms.append(a.elapsed_time(b))
    fakes = torch.cat(fakes)
    embed_ms = []

    def embed(x):
        feats = []
        for i in range(0, len(x), EVAL_EMB_BS):
            a, b = ev(), ev()
            a.record()
            feats.append(embed_videos(embedder, emb_params,
                                      x[i:i + EVAL_EMB_BS], EVAL_EMB_BS))
            b.record()
            torch.cuda.synchronize()
            embed_ms.append(a.elapsed_time(b))
        return torch.cat(feats)

    feats_real = embed(videos[:EVAL_FAKES])
    feats_fake = embed(fakes)
    fake_frames = fakes[torch.arange(EVAL_FAKES), frame_ix[:EVAL_FAKES].to(dev)]
    probs = torch.softmax(apply(classifier, cls_params, fake_frames), -1)
    torch.cuda.synchronize()
    t_fvd = time.perf_counter()
    stats = [feature_stats(f) for f in (feats_real, feats_fake)]
    fvd_value = frechet_distance(*stats[0], *stats[1])
    fvd_ms = (time.perf_counter() - t_fvd) * 1e3
    is_mean, is_std = inception_score(probs)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t_eval
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k1, k2 = fused_rk4.launches, fused_gru.launches
    ms64, ms32 = sum(sample_ms) / len(sample_ms), sum(embed_ms) / len(embed_ms)
    say(f"ucf_wgan_gp_128 eval of {EVAL_FAKES} fakes against {EVAL_FAKES} "
        f"reals: FVD {fvd_value:.4f}, IS {is_mean:.4f} +- {is_std:.4f}; "
        f"sample_videos({EVAL_CHUNK}) {ms64:.2f} ms, embed of "
        f"{EVAL_EMB_BS} clips {ms32:.2f} ms, FVD (stats on the card, the "
        f"distance on the host in float64) {fvd_ms:.2f} ms; the whole eval "
        f"{eval_s:.3f} s, {EVAL_FAKES / eval_s:.1f} clips/s scored, peak "
        f"{peak:.2f} GiB; K1 +{k1}, K2 +{k2}; {card}")
    require(math.isfinite(fvd_value) and math.isfinite(is_mean)
            and bool(torch.isfinite(fakes).all()),
            f"eval not finite: FVD {fvd_value}, IS {is_mean}")
    require(k1 == 0 and k2 == 0, f"the dopri5 eval launched K1 {k1}, K2 {k2}")
    out["north_star_geometry"] = {
        "fvd": fvd_value, "is_mean": is_mean, "is_std": is_std,
        "embedder_acc": emb_acc, "classifier_acc": cls_acc,
        "feature_rel_err": feat_err, "prob_rel_err": prob_err,
        "ms_per_sample_64": ms64, "sample_ms": sample_ms,
        "ms_per_embed_32": ms32, "fvd_ms": fvd_ms, "eval_seconds": eval_s,
        "clips_per_s": EVAL_FAKES / eval_s, "peak_gib": peak,
        "train_seconds": train_s, "k1_launches": k1, "k2_launches": k2}
    del videos, frames, fakes, gen
    torch.cuda.empty_cache()
    say(f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase(f"the evaluate command in process: python -m "
          f"ganode_tpu_torch.evaluate --config ucf_ode --synthetic "
          f"--n-samples {EVAL_CLI_SAMPLES} --classifier-steps {EVAL_STEPS} on "
          f"a fresh 2-step full-width run, twice on the same assets")
    tmp = tempfile.mkdtemp(prefix="ganode_eval_")
    try:
        wd, assets = os.path.join(tmp, "run"), os.path.join(tmp, "assets")
        runner.run_training(get_config("ucf_ode"), wd, steps=2,
                            synthetic=True, device=dev)
        argv = ["--config", "ucf_ode", "--workdir", wd, "--synthetic",
                "--n-samples", str(EVAL_CLI_SAMPLES), "--classifier-steps",
                str(EVAL_STEPS), "--assets-dir", assets]
        runs = []
        for _ in range(2):
            reset_counts()
            t1 = time.perf_counter()
            result = evaluate.main(argv)
            torch.cuda.synchronize()
            runs.append((result, fused_rk4.launches, fused_gru.launches,
                         time.perf_counter() - t1))
        (r1, k1_1, k2_1, s1), (r2, k1_2, k2_2, s2) = runs
        with open(os.path.join(wd, "eval.json")) as f:
            require(json.load(f) == r2, "eval.json is not the second result")
        want_k1 = EVAL_CLI_SAMPLES // 64
        say(f"evaluate ucf_ode: run 1 (assets trained) {s1:.1f} s, K1 +{k1_1}, "
            f"K2 +{k2_1}: {json.dumps(r1)}")
        say(f"evaluate ucf_ode: run 2 (assets loaded) {s2:.1f} s, K1 +{k1_2}, "
            f"K2 +{k2_2}: FVD {r2['fvd']}, IS {r2['inception_score_mean']}; "
            f"{card}")
        require(list(r1) == JAX_EVAL_KEYS, f"eval.json keys {list(r1)}")
        require(r1["checkpoint_step"] == 2 and r1["n_fake_videos"] ==
                EVAL_CLI_SAMPLES and all(
                    math.isfinite(r[k]) for r in (r1, r2) for k in (
                        "fvd", "inception_score_mean", "inception_score_std")),
                f"eval.json values: {r1}, {r2}")
        require(k1_1 == k1_2 == want_k1 and k2_1 == k2_2 == 0,
                f"evaluate launched K1 {k1_1}, {k1_2} (want {want_k1}), "
                f"K2 {k2_1}, {k2_2}")
        require(r1["classifier_train_acc"] is not None
                and r2["classifier_train_acc"] is None
                and r2["embedder_train_acc"] is None
                and r2["asset_hashes"] == r1["asset_hashes"],
                f"assets not reloaded unchanged: {r1['asset_hashes']}, "
                f"{r2['asset_hashes']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["evaluate_cli"] = {"runs": [r1, r2], "seconds": [s1, s2],
                           "k1_launches": [k1_1, k1_2],
                           "k2_launches": [k2_1, k2_2]}
    say(f"{time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# The int8 serving trunk (phases 41-44): K3 and the three deconv trunks.
# ---------------------------------------------------------------------------
INT8_CONFIGS = ("ucf_ode", "mnist_ode", "ucf_wgan_gp_128")
# launches per int8 sample_videos(64): K3 once per trunk layer; K1 once on
# the rk4 motion, never on dopri5 (as in JAX)
INT8_K3_LAUNCHES = {"ucf_ode": 5, "mnist_ode": 5, "ucf_wgan_gp_128": 6}
INT8_K1_LAUNCHES = {"ucf_ode": 1, "mnist_ode": 1, "ucf_wgan_gp_128": 0}
# JAX's bars for int8 frames against the float trunk's
# (tests/test_ops.py::TestInt8Serving): (max, mean) with dynamic scales,
# and with static scales calibrated on another batch
INT8_BARS = {"dynamic": (0.15, 0.02), "static": (0.2, 0.02)}
# The card's int8 frames against the CPU's plain int8 path on the same
# latents and scales: the same IEEE operations give the same codes at every
# layer (0 may differ), so the frames differ only by the two tanh.
TOL_INT8_CARD_CPU = 1e-6
INT8_CPU_CLIPS = 2      # clips decoded on the CPU for that check
PEAK_INT8_OPS_S = 1979e12   # H100 SXM dense int8 tensor-core ops/s
# K3's kernels in the build: deconv_i8_kernel_tc<BN, BK> and
# deconv_i8_kernel_bytes<k, s, p> (csrc/int8_deconv.cu)
K3_TC_VARIANTS, K3_BYTES_VARIANTS = 4, 2
REFERENCE_EPOCH = 41000


def int8_layer_shapes(cfg):
    """``(B', Hi, Ci, Co, k, s, p)`` of each K3 call of ``cfg``'s int8
    trunk in one ``sample_videos(64)``: B' = 64 T frames, the layer's own
    input channels (the trunk feeds K3 its codes zero-padded to the plan's
    ``ci4``); the weights' shapes from the trunk built on the meta device."""
    import torch

    from ganode_tpu_torch.models.mocogan import make_trunk
    from ganode_tpu_torch.ops.quant import TRUNK_GEOMETRY

    dim_z = cfg.dim_z_content + cfg.dim_z_category + cfg.dim_z_motion
    with torch.device("meta"):
        sd = make_trunk(cfg.trunk, cfg.n_channels, cfg.ngf, dim_z).state_dict()
    b, hw, out = 64 * cfg.video_length, 1, []
    for name, _, s, p in TRUNK_GEOMETRY[cfg.trunk]:
        w = sd[f"{name}.weight"]   # (Ci, Co, k, k); Conv_0's (Co, Ci, 1, 1)
        ci, co = (w.shape[1], w.shape[0]) if name.startswith("Conv_") \
            else (w.shape[0], w.shape[1])
        k = w.shape[-1]
        out.append((b, hw, ci, co, k, s, p))
        hw = (hw - 1) * s - 2 * p + k
    return out


def deconv_i8_cost(b, hi, ci, co, k, s, p):
    """(operations, bytes) of one K3 call with the float epilogue over the
    layer's ``ci`` real input channels (the zeros K3's channel padding adds
    are no work of the function): 2 per product of the taps that land inside
    the output (a border tap that falls in the padding is no work), the
    codes, the weights, scale and bias read once and the float32 output
    written once."""
    ho = (hi - 1) * s - 2 * p + k
    taps = sum(1 for i in range(hi) for kk in range(k) if 0 <= i * s - p + kk < ho)
    ops = 2 * b * taps * taps * ci * co
    nbytes = b * hi * hi * ci + k * k * co * ci + 8 * co + 4 + 4 * b * ho * ho * co
    return ops, nbytes


def int8_bound_ms(ops, nbytes):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_INT8_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def synthetic_reference_checkpoint(cfg, seed):
    """A checkpoint in the reference's ``torch.save`` format ({'epoch',
    'model_state_dict': [gen, disVid, disImg], 'optimizer_state_dict'}) of
    ``cfg``'s nets at full width, with seeded values: each port tensor
    perturbed (BatchNorm statistics drawn) and mapped to its reference key
    by ``compat_torch``'s rules, each its own inverse; Adam moments for
    every parameter but the ODE variants' unused inherited ``recurrent`` GRU,
    which the reference carries without Adam state. -> (ckpt, the port-layout
    values the import must give: {net: {key: tensor}}, and the moments:
    {net: {key: (exp_avg, exp_avg_sq)}})."""
    import torch

    from ganode_tpu_torch import compat_torch
    from ganode_tpu_torch.train import build_trainer

    g = torch.Generator().manual_seed(seed)
    rand = lambda shape, scale: torch.randn(shape, generator=g) * scale
    state = build_trainer(cfg, device="cpu").init_state()
    mappings = {"gen": compat_torch.generator_mapping(cfg.variant, cfg.trunk),
                "dis_vid": compat_torch.video_discriminator_mapping(
                    cfg.video_disc, cfg.video_disc_ksize),
                "dis_img": compat_torch.image_discriminator_mapping(
                    cfg.image_disc)}
    models, opts, values, moments = [], [], {}, {}
    for net, mapping in mappings.items():
        sd = getattr(state, net).module.state_dict()
        ref, mom = {}, {}
        if net == "gen" and cfg.variant in ("ode", "sde", "cde"):
            d = cfg.dim_z_motion
            for leaf, shape in (("weight_ih", (3 * d, d)), ("weight_hh", (3 * d, d)),
                                ("bias_ih", (3 * d,)), ("bias_hh", (3 * d,))):
                ref[f"recurrent.{leaf}"] = rand(shape, 0.1)
        values[net], moments[net] = {}, {}
        for key, (ref_key, rule) in mapping.items():
            v = sd[key]
            if key.endswith("running_var"):
                new = torch.rand(v.shape, generator=g) + 0.5
            elif key.endswith("running_mean"):
                new = rand(v.shape, 0.1)
            else:
                new = v + rand(v.shape, 0.01)
                m = (rand(v.shape, 1e-3), rand(v.shape, 1e-6).abs())
                moments[net][key] = m
                mom[ref_key] = tuple(rule(t).contiguous() for t in m)
            values[net][key] = new
            ref[ref_key] = rule(new).contiguous()
            if key.endswith("running_var"):
                ref[ref_key.replace("running_var", "num_batches_tracked")] = \
                    torch.tensor(REFERENCE_EPOCH)
        names = [k for k in ref if not k.endswith(
            ("running_mean", "running_var", "num_batches_tracked"))]
        opts.append({"state": {i: {"step": torch.tensor(float(REFERENCE_EPOCH)),
                                   "exp_avg": mom[k][0], "exp_avg_sq": mom[k][1]}
                               for i, k in enumerate(names) if k in mom},
                     "param_groups": [{"lr": cfg.lr, "betas": tuple(cfg.betas),
                                       "eps": 1e-8, "weight_decay": cfg.weight_decay,
                                       "amsgrad": False,
                                       "params": list(range(len(names)))}]})
        models.append(ref)
    return ({"epoch": REFERENCE_EPOCH, "model_state_dict": models,
             "optimizer_state_dict": opts}, values, moments)


def k3_sass(lib_path) -> dict:
    """Per K3 kernel in the built library, whether its SASS holds
    warpgroup MMA instructions (``GMMA``: IGMMA for s8), from
    ``cuobjdump -sass``."""
    from ganode_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    found, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if "deconv_i8_kernel" in name:
                found[name] = False
        elif name in found and "GMMA" in line:
            found[name] = True
    return found


def int_mm_ms(b, hi, ci, co, k, s, p, g, dev, n):
    """torch._int_mm (cuBLASLt's int8 GEMM; the port never calls it) on the
    dense GEMM of one K3 layer with Co >= 8, per parity class: M = B' Ho Wo
    / s^2, N = Co, K = taps Ci4, Ci padded to 32 as K3 reads it (the 1x1
    first layer: M = B', N = k^2 Co, K = Ci4, the GEMM K3 runs), times the
    s^2 classes; None where _int_mm refuses the shape."""
    import torch

    ho = (hi - 1) * s - 2 * p + k
    ci4 = -(-ci // 32) * 32   # as K3 reads the channels (_int_mm: K % 8 == 0)
    if hi == 1 and p == 0:
        m, nn, kk, classes = b, k * k * co, ci4, 1
    else:
        taps = (-(-k // s)) ** 2
        m, nn, kk, classes = b * ho * ho // (s * s), co, taps * ci4, s * s
    a = torch.randint(-127, 128, (m, kk), generator=g, dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (nn, kk), generator=g, dtype=torch.int8).to(dev)
    try:
        torch._int_mm(a, w.t())
    except RuntimeError as e:
        say(f"  torch._int_mm refuses ({m}, {kk}) x ({kk}, {nn}): {str(e)[:120]}")
        return None
    return classes * device_ms(lambda: torch._int_mm(a, w.t()), n)


# K3's shapes that cross tile edges, as tests/test_torch_cuda.py has them:
# (B, Hi, Ci4, Co, k, s, p)
K3_EDGE_SHAPES = [(70, 1, 68, 130, 4, 1, 0), (9, 4, 64, 64, 4, 2, 1),
                  (5, 7, 32, 3, 4, 2, 1), (3, 6, 12, 1, 1, 1, 0),
                  (2, 2, 2048, 70, 4, 2, 1), (3, 5, 64, 96, 4, 2, 1),
                  (2, 4, 64, 200, 4, 2, 1), (1, 130, 32, 16, 4, 2, 1),
                  (4, 3, 20, 40, 4, 2, 1), (2, 5, 32, 5, 3, 2, 1),
                  (2, 3, 32, 16, 1, 2, 0), (3, 1, 64, 24, 4, 1, 1)]


def k3_codes(shape, extreme, g):
    """Random int8 codes for one K3 call, or +-127 ones (every product
    127^2 in magnitude, a quarter of the weights negative)."""
    import torch

    b, hw, ci4, co, k, s, p = shape
    if extreme:
        xq = torch.full((b, hw, hw, ci4), 127, dtype=torch.int8)
        w = torch.where(torch.rand((k, k, co, ci4), generator=g) < 0.25,
                        -127, 127).to(torch.int8)
    else:
        xq = torch.randint(-127, 128, (b, hw, hw, ci4), generator=g,
                           dtype=torch.int8)
        w = torch.randint(-127, 128, (k, k, co, ci4), generator=g,
                          dtype=torch.int8)
    return xq, w


def k3_exact(xq, w, s, p, g, dev, what) -> tuple:
    """K3 on the card against its plain version there and on the CPU (2
    frames), int32 and the fused epilogue, all bit for bit; -> (the plain
    sums' largest magnitude, K3's largest error, the epilogue's inputs)."""
    import torch

    from ganode_tpu_torch.ops import quant

    co = w.shape[2]
    before = quant.launches
    got = quant.deconv_i8(xq, w, s, p)
    torch.cuda.synchronize()
    require(quant.launches == before + 1, "K3's counter did not rise")
    want = quant.reference_deconv_i8(xq, w, s, p)
    cpu = quant.reference_deconv_i8(xq[:2].cpu(), w.cpu(), s, p)
    a = torch.full((), 0.0123, device=dev)
    sc = torch.rand(co, generator=g).to(dev)
    bi = torch.randn(co, generator=g).to(dev)
    gf = quant.deconv_i8(xq, w, s, p, a_scale=a, scale=sc, bias=bi, relu=True)
    wf = torch.relu(want.float() * (a * sc) + bi)
    bad = (int((got != want).sum()), int((got[:2].cpu() != cpu).sum()),
           int((gf != wf).sum()))
    require(bad == (0, 0, 0), f"K3 {what}: mismatches (int32, vs CPU, float) {bad}")
    err = int((got.long() - want.long()).abs().max())
    return int(want.abs().max()), err, (a, sc, bi)


def k3_layer_phase(dev, card) -> dict:
    """Phase 41 (module docstring): K3's SASS, K3 bit for bit at every
    full-width layer and edge shape, and per layer the times; returns
    ``{"layers": {config: [...]}, "max_abs_err", "sass", "edge_shapes"}``."""
    import torch
    import torch.nn.functional as F

    from ganode_tpu_torch.ops import _build, quant
    from ganode_tpu_torch.utils.config import get_config

    out = {"layers": {}}
    t0 = time.perf_counter()
    phase("K3 deconv_i8: warpgroup MMA (GMMA) in the SASS of its tensor-core "
          "kernel; against its plain version (F.conv_transpose2d in float64, "
          "rounded) at every layer of the full-width int8 trunks of "
          f"{', '.join(INT8_CONFIGS)} (B' = 64 T frames) and at "
          f"{len(K3_EDGE_SHAPES)} shapes that cross tile edges, random and "
          "+-127 codes, int32 and the fused float32 epilogue; per layer K3's, "
          "the plain version's, cuDNN's bf16 and TF32 conv_transpose2d and "
          "torch._int_mm's times")
    sass = k3_sass(_build.library_path())
    for name, has in sass.items():
        say(f"  SASS {name}: {'GMMA' if has else 'no GMMA'}")
    tc = {n: h for n, h in sass.items() if "deconv_i8_kernel_tc" in n}
    require(tc and all(tc.values()),
            f"K3's tensor-core kernels without warpgroup MMA in SASS: {sass}")
    out["sass"] = {"tensor_core_kernels": len(tc), "with_gmma": sum(tc.values())}
    g = torch.Generator().manual_seed(41)
    worst = 0
    for shape in K3_EDGE_SHAPES:
        b, hw, ci4, co, k, s, p = shape
        for extreme in (False, True):
            xq, w = (t.to(dev) for t in k3_codes(shape, extreme, g))
            _, err, _ = k3_exact(xq, w, s, p, g, dev,
                                 f"edge {shape} extreme={extreme}")
            worst = max(worst, err)
    say(f"K3 exact at the {len(K3_EDGE_SHAPES)} edge shapes, random and +-127")
    out["edge_shapes"] = len(K3_EDGE_SHAPES)
    for name in INT8_CONFIGS:
        cfg = get_config(name)
        layers = []
        for shape in int8_layer_shapes(cfg):
            b, hw, ci, co, k, s, p = shape
            plan = quant.k3_plan(b, hw, hw, ci, co, k, s, p)
            peak = 0
            for extreme in (False, True):
                # the codes and weights zero-padded to K3's channels, as the
                # trunk holds them
                xq, w = (F.pad(t, (0, plan.ci4 - ci)).to(dev)
                         for t in k3_codes(shape, extreme, g))
                top, err, (a, sc, bi) = k3_exact(
                    xq, w, s, p, g, dev, f"{name} {shape} extreme={extreme}")
                peak, worst = max(peak, top), max(worst, err)
            n = 10 if b > 1024 else 20
            k3_ms = device_ms(lambda: quant.deconv_i8(
                xq, w, s, p, a_scale=a, scale=sc, bias=bi, relu=True), n)
            plain_ms = events_ms(lambda: quant.reference_deconv_i8(xq, w, s, p), 3)
            xf = torch.randn((b, ci, hw, hw), generator=g).to(dev)
            wt = torch.randn((ci, co, k, k), generator=g).to(dev)
            cudnn = {}
            for tag, dt in (("bf16", torch.bfloat16), ("tf32", torch.float32)):
                torch.backends.cudnn.allow_tf32 = True
                xd, wd = xf.to(dt), wt.to(dt)
                cudnn[tag] = device_ms(lambda: F.conv_transpose2d(
                    xd, wd, stride=s, padding=p), n)
            imm = int_mm_ms(b, hw, ci, co, k, s, p, g, dev, n) if co >= 8 else None
            ops, nbytes = deconv_i8_cost(b, hw, ci, co, k, s, p)
            bound, by = int8_bound_ms(ops, nbytes)
            rec = {"shape": [b, hw, ci, co, k, s, p], "ci4": plan.ci4,
                   "route": plan.route,
                   "ms": k3_ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": by, "of_bound": bound / k3_ms,
                   "cudnn_bf16_ms": cudnn["bf16"], "cudnn_tf32_ms": cudnn["tf32"],
                   "int_mm_ms": imm, "gop": ops / 1e9, "mbytes": nbytes / 1e6,
                   "max_abs_sum": peak}
            layers.append(rec)
            say(f"K3 {name} B'={b} {hw}x{hw} {ci}->{co} k{k}s{s}p{p}, read as "
                f"{plan.ci4} channels "
                f"({plan.route}{', one-tap GEMM' if plan.gemm else ''}): exact "
                f"(random and +-127, |sum| up to {peak}); K3 {k3_ms * 1e3:.1f} "
                f"us, plain {plain_ms * 1e3:.1f} us, cuDNN bf16 "
                f"{cudnn['bf16'] * 1e3:.1f} / TF32 {cudnn['tf32'] * 1e3:.1f} us,"
                f" _int_mm {'-' if imm is None else f'{imm * 1e3:.1f}'} us; "
                f"bound {bound * 1e3:.2f} us ({by}: {ops / 1e9:.1f} GOP, "
                f"{nbytes / 1e6:.1f} MB), {bound / k3_ms:.1%} of it; {card}")
            del xq, w, xf, wt, xd, wd
        out["layers"][name] = layers
        k3_sum = sum(l["ms"] for l in layers)
        say(f"K3 {name}: {k3_sum:.3f} ms per int8 sample_videos(64) summed "
            f"over layers; cuDNN bf16 {sum(l['cudnn_bf16_ms'] for l in layers):.3f}"
            f" ms, bound {sum(l['bound_ms'] for l in layers):.3f} ms")
        torch.cuda.empty_cache()
    out["max_abs_err"] = worst
    say(f"{time.perf_counter() - t0:.1f} s")
    return out


def int8_phases(dev, card) -> dict:
    """Phases 41-44 (module docstring): K3 at every full-width layer, int8
    serving of the three deconv configs, the import and serving commands,
    and a profiler trace; returns the record's entry."""
    import glob

    import numpy as np
    import torch

    from ganode_tpu_torch.compat import GeneratorSession
    from ganode_tpu_torch.generate import sample_videos_int8
    from ganode_tpu_torch.models import generator_for_config
    from ganode_tpu_torch.ops import fused_gru, fused_rk4, quant
    from ganode_tpu_torch.train import build_trainer
    from ganode_tpu_torch.utils import gifs, profiling
    from ganode_tpu_torch.utils.checkpoint import CheckpointManager
    from ganode_tpu_torch.utils.config import get_config

    out = {"layers": {}, "serving": {}}
    out.update(k3_layer_phase(dev, card))

    sessions = {}
    for name in INT8_CONFIGS:
        t0 = time.perf_counter()
        cfg = get_config(name)
        t = cfg.video_length
        phase(f"serve {name} at full width ({cfg.trunk}, ngf={cfg.ngf}, "
              f"{cfg.motion_method or 'rk4'} motion) through the int8 trunk: "
              f"sample_videos(64) float, int8 dynamic and int8 static; counts, "
              "frames against the float trunk's and the CPU's plain int8 path")
        gen = generator_for_config(cfg, device=dev)
        with torch.no_grad():
            z_cal, _ = gen.sample_z_video(
                64, t, generator=torch.Generator(dev).manual_seed(7))
            gen.main.train()
            gen.main(z_cal)   # non-trivial BatchNorm statistics, as JAX's tests
            gen.main.eval()
        sess = GeneratorSession(gen, seed=0, device=dev)
        qs = quant.quantize_trunk(cfg.trunk, gen.main)
        scales = quant.calibrate_act_scales(cfg.trunk, gen.main, z_cal)
        float_bytes = sum(v.numel() * v.element_size()
                          for v in gen.main.state_dict().values()
                          if v.is_floating_point())
        # what the int8 state holds on the card: every tensor, by storage
        on_card = [v for l in qs["layers"] for v in l.values()
                   if isinstance(v, torch.Tensor) and v.device.type == "cuda"]
        int8_bytes = sum(v.untyped_storage().nbytes() for v in on_card)
        kernel_bytes = sum(v.untyped_storage().nbytes() for v in on_card
                           if v.dtype == torch.int8)
        require(kernel_bytes == sum(l["packed"].numel() for l in qs["layers"]),
                f"{name}: the int8 state holds more than one copy of its kernels")
        counts = {}
        for mode, sc in (("dynamic", None), ("static", scales)):
            reset_counts()
            v = sample_videos_int8(sess, cfg.trunk, qs, 64, act_scales=sc)
            torch.cuda.synchronize()
            counts[mode] = (quant.launches, fused_rk4.launches, fused_gru.launches)
            size = FRAME_SIZE[cfg.trunk]
            require(tuple(v.shape) == (64, t, size, size, cfg.n_channels)
                    and bool(torch.isfinite(v).all()) and v.abs().max() <= 1.0,
                    f"{name} int8 {mode} videos {tuple(v.shape)}")
            require(counts[mode] == (INT8_K3_LAUNCHES[name],
                                     INT8_K1_LAUNCHES[name], 0),
                    f"{name} int8 {mode}: K3, K1, K2 launched {counts[mode]}")
        with torch.no_grad():
            z, _ = gen.sample_z_video(64, t, generator=torch.Generator(dev).manual_seed(8))
            torch.backends.cudnn.allow_tf32 = False
            want, want_cal = gen.main(z), gen.main(z_cal)
            errs = {}
            for mode, zz, ref, sc in (("dynamic", z, want, None),
                                      ("static", z, want, scales),
                                      ("static_calibration_batch", z_cal,
                                       want_cal, scales)):
                d = (quant.int8_trunk_apply(cfg.trunk, qs, zz, sc) - ref).abs()
                errs[mode] = (d.max().item(), d.mean().item())
            # the card against the CPU's plain int8 path, same latents/scales
            main_cpu = copy.deepcopy(gen.main).cpu()
            qs_cpu = quant.quantize_trunk(cfg.trunk, main_cpu)
            state_diff = sum(int((a[k].cpu() != b[k]).sum()) + (a["ci"] != b["ci"])
                             for a, b in zip(qs["layers"], qs_cpu["layers"])
                             for k in ("packed", "scale", "bias"))
            zs = z[:INT8_CPU_CLIPS * t]
            card_cpu = {}
            for mode, sc in (("dynamic", None), ("static", scales)):
                cd, cc = [], []
                od = quant.int8_trunk_apply(cfg.trunk, qs, zs, sc, codes=cd)
                oc = quant.int8_trunk_apply(
                    cfg.trunk, qs_cpu, zs.cpu(),
                    None if sc is None else [x.cpu() for x in sc], codes=cc)
                flips = sum(int((a.cpu() != b).sum()) for a, b in zip(cd, cc))
                card_cpu[mode] = {"flipped_codes": flips,
                                  "codes": sum(b.numel() for b in cc),
                                  "max_abs": (od.cpu() - oc).abs().max().item()}
        for mode, (mx, mean) in errs.items():
            bar = INT8_BARS["dynamic" if mode != "static" else "static"]
            require(mx < bar[0] and mean < bar[1],
                    f"{name} int8 {mode} frames {mx}, {mean} from the float "
                    f"trunk's (bars {bar})")
        require(state_diff == 0, f"{name}: the int8 state differs between the "
                f"card and the CPU in {state_diff} elements")
        for mode, r in card_cpu.items():
            require(r["flipped_codes"] == 0 and r["max_abs"] < TOL_INT8_CARD_CPU,
                    f"{name} int8 {mode} card vs CPU: {r}")
        torch.backends.cudnn.allow_tf32 = True
        n = 5 if cfg.trunk == "dcgan128" else 10
        ms = {"float": events_ms(lambda: sess.sample_videos(64), n),
              "int8_dynamic": events_ms(lambda: sample_videos_int8(
                  sess, cfg.trunk, qs, 64), n),
              "int8_static": events_ms(lambda: sample_videos_int8(
                  sess, cfg.trunk, qs, 64, act_scales=scales), n)}
        with torch.no_grad():
            torch.cuda.reset_peak_memory_stats()
            trunk_ms = {"float": events_ms(lambda: gen.main(z), n),
                        "int8_dynamic": events_ms(lambda: quant.int8_trunk_apply(
                            cfg.trunk, qs, z), n),
                        "int8_static": events_ms(lambda: quant.int8_trunk_apply(
                            cfg.trunk, qs, z, scales), n)}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        k3_sum = sum(l["ms"] for l in out["layers"][name])
        say(f"{name}: sample_videos(64) float {ms['float']:.3f} ms, int8 "
            f"dynamic {ms['int8_dynamic']:.3f}, static {ms['int8_static']:.3f} "
            f"(cuDNN TF32 on); the trunk alone ({64 * t} frames) "
            f"{trunk_ms['float']:.3f} / {trunk_ms['int8_dynamic']:.3f} / "
            f"{trunk_ms['int8_static']:.3f} ms, K3's layers alone "
            f"{k3_sum:.3f} ms; peak {peak:.2f} GiB; {card}")
        say(f"{name}: int8 frames against the float trunk's (TF32 off), "
            f"max / mean: dynamic {errs['dynamic'][0]:.4f} / "
            f"{errs['dynamic'][1]:.5f}, static on fresh z "
            f"{errs['static'][0]:.4f} / {errs['static'][1]:.5f}, static on its "
            f"calibration batch {errs['static_calibration_batch'][0]:.4f}; "
            f"card vs CPU plain int8 ({INT8_CPU_CLIPS * t} frames): flipped "
            f"codes {card_cpu['dynamic']['flipped_codes']} / "
            f"{card_cpu['static']['flipped_codes']} of "
            f"{card_cpu['dynamic']['codes']}, frames within "
            f"{max(r['max_abs'] for r in card_cpu.values()):.2e}; launches per "
            f"call K3 {counts['dynamic'][0]}, K1 {counts['dynamic'][1]}, K2 "
            f"{counts['dynamic'][2]}; weights {float_bytes / 1e6:.2f} MB float"
            f" -> {int8_bytes / 1e6:.2f} MB int8 on the card, {kernel_bytes / 1e6:.2f}"
            f" MB of it the kernels, once, in K3's packing; "
            f"{time.perf_counter() - t0:.1f} s")
        out["serving"][name] = {
            "ms_per_sample_64": ms, "trunk_ms": trunk_ms,
            "k3_layers_ms": k3_sum, "peak_gib": peak,
            "err_vs_float": errs, "card_vs_cpu": card_cpu,
            "launches_per_call": {m: dict(zip(("k3", "k1", "k2"), c))
                                  for m, c in counts.items()},
            "weight_bytes": {"float": float_bytes, "int8_on_card": int8_bytes,
                             "int8_kernels": kernel_bytes}}
        if name == "ucf_ode":
            sessions[name] = (sess, qs)
        else:
            del sess, gen
        del qs, scales, z, z_cal, want, want_cal
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase("the serving commands: a synthetic full-width mnist_ode reference "
          "checkpoint, python -m ganode_tpu_torch.import_reference, then "
          "python -m ganode_tpu_torch.generate --workdir --int8 --gif, in "
          "child processes")
    cfg = get_config("mnist_ode")
    tmp = tempfile.mkdtemp(prefix="ganode_import_")
    try:
        ckpt, values, moments = synthetic_reference_checkpoint(cfg, seed=43)
        path = os.path.join(tmp, f"state_normal{REFERENCE_EPOCH}.ckpt")
        torch.save(ckpt, path)
        wd = os.path.join(tmp, "run")
        printed = run_child([sys.executable, "-m",
                             "ganode_tpu_torch.import_reference", "--ckpt",
                             path, "--config", "mnist_ode", "--workdir", wd],
                            "the import_reference command")
        require(f"imported reference step {REFERENCE_EPOCH}" in printed,
                f"import_reference printed {printed}")
        tr = build_trainer(cfg, device=dev)
        state = CheckpointManager(os.path.join(wd, "checkpoints")).restore(
            tr.init_state())
        mism = 0
        for net, vals in values.items():
            module = getattr(state, net).module
            sd = module.state_dict()
            mism += sum(int((sd[k].cpu() != v).sum()) for k, v in vals.items())
            params = dict(module.named_parameters())
            for k, (m, v) in moments[net].items():
                s = getattr(state, net).opt.state[params[k]]
                mism += int((s["exp_avg"].cpu() != m).sum()
                            + (s["exp_avg_sq"].cpu() != v).sum())
                mism += int(float(s["step"]) != REFERENCE_EPOCH)
        require(state.step == REFERENCE_EPOCH and mism == 0,
                f"the imported checkpoint: step {state.step}, {mism} "
                "elements differ from the reference's")
        npz, gif = os.path.join(tmp, "v.npz"), os.path.join(tmp, "g.gif")
        printed = run_child([sys.executable, "-m", "ganode_tpu_torch.generate",
                             "--config", "mnist_ode", "--workdir", wd, "--int8",
                             "--num", "16", "--out", npz, "--gif", gif],
                            "generate --workdir --int8")
        require(f"restored step {REFERENCE_EPOCH}" in printed,
                f"generate printed {printed}")
        videos = np.load(npz)["videos"]
        sess = GeneratorSession(tr.gen, tr.eval_gen_variables(state), seed=0,
                                device=dev)
        qs = quant.quantize_trunk(cfg.trunk, sess.gen.main)
        want = sample_videos_int8(sess, cfg.trunk, qs, 16).cpu().numpy()
        diff = np.abs(videos - want)
        frames = gifs.read_gif(gif)
        grid = np.repeat(gifs.video_grid(videos, 4), 3, axis=-1)
        require(videos.shape == (16, 16, 28, 28, 1) and diff.max() < 0.15
                and diff.mean() < 1e-4,
                f"served int8 videos {videos.shape}, max {diff.max()}, mean "
                f"{diff.mean()} from the same sampling in this process")
        require(frames.shape == grid.shape and np.array_equal(frames, grid),
                f"GIF {frames.shape} does not decode to the 4x4 grid")
        seconds = time.perf_counter() - t0
        say(f"imported a full-width mnist_ode reference checkpoint (step "
            f"{REFERENCE_EPOCH}, {os.path.getsize(path) / 2 ** 20:.1f} MiB) "
            f"through the command: every weight, BatchNorm statistic and Adam "
            f"moment as written; generate --workdir --int8 served it, "
            f"{videos.shape}, max|diff| {diff.max():.1e} from the same "
            f"sampling in this process; GIF decoded to its grid exactly; "
            f"{seconds:.1f} s; {card}")
        out["commands"] = {"seconds": seconds, "max_abs_vs_process":
                           float(diff.max()), "ckpt_mib":
                           os.path.getsize(path) / 2 ** 20}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    phase("profiling.trace of one int8 sample_videos(64) of ucf_ode under "
          "profiling.annotate")
    sess, qs = sessions["ucf_ode"]
    tmp = tempfile.mkdtemp(prefix="ganode_trace_")
    try:
        with profiling.trace(tmp):
            with profiling.annotate("int8 serve ucf_ode"):
                sample_videos_int8(sess, "dcgan64", qs, 64)
        files = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        require(len(files) == 1, f"trace files {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        k3_us = sum(e["dur"] for e in kernels if "deconv_i8_kernel" in e["name"])
        k1_us = sum(e["dur"] for e in kernels if "rk4_warp_kernel" in e["name"])
        require("int8 serve ucf_ode" in names and k3_us > 0 and k1_us > 0,
                f"the trace lacks the annotation, K3 or K1 ({len(events)} "
                "events)")
        # one stream: the kernels run one after another, so the device is
        # idle for the span from the first kernel's start to the last one's
        # end less their durations (the host launching, or waiting)
        busy = sum(e["dur"] for e in kernels)
        span = (max(e["ts"] + e["dur"] for e in kernels)
                - min(e["ts"] for e in kernels))
        host = [e["dur"] for e in events if e.get("name") == "int8 serve ucf_ode"
                and e.get("cat") == "user_annotation"]
        say(f"trace {os.path.basename(files[0])} ({os.path.getsize(files[0])} "
            f"bytes, {len(events)} events): the annotation, "
            f"{sum('deconv_i8_kernel' in n for n in names)} K3 kernels "
            f"({k3_us:.0f} us) and K1 ({k1_us:.0f} us); {len(kernels)} kernels"
            f" {busy:.0f} us in a device span of {span:.0f} us "
            f"({1 - busy / span:.1%} idle); the host enqueued the call in "
            f"{host[0] if host else float('nan'):.0f} us; {card}")
        out["trace"] = {"k3_us": k3_us, "k1_us": k1_us, "kernel_us": busy,
                        "kernels": len(kernels), "device_span_us": span,
                        "idle_share": 1 - busy / span,
                        "host_call_us": host[0] if host else None,
                        "events": len(events)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# The data library (phase 47) and the parallel layouts (phases 48-50). The
# card has one H100: the N-way step runs as two gloo ranks sharing it (every
# message of a CUDA tensor through pinned host memory, parallel/comm.py),
# and NCCL as a group of one. What they show is the N-way step's result
# against the single-process one; no speed is expected from two ranks on
# one card.
# ---------------------------------------------------------------------------

ROTMNIST_DIGITS = 256  # idx digits rotated into 16-frame clips (phase 47)
DATA_STEPS = 2
# the keyed transforms on the card against the CPU, same draws: the crops,
# flips and windows move values (exact); the antialiased bilinear resizes
# sum float32 filter taps in another order
TOL_TRANSFORM = 1e-5
MESH_STEPS = 2
# a checkpoint after every step: the N-way run and the single-process one
# are compared after their first step (checkpoint "0")
MESH_RUN = {"log_every": 1, "sample_every": 0, "checkpoint_every": 1}
# N-way against single-process on the card after one step (cuDNN
# deterministic, TF32 off). The two differ by rounding at first (the batch
# statistics combine the ranks' own, the normalisation is not cuDNN's
# kernel, cuDNN picks its algorithms per local batch); Adam's first
# updates turn that into a whole step wherever a gradient that cancels to
# near zero flips its sign, and D's later passes in the step see those
# moved weights. Bars: the first step's losses within a relative 1e-3;
# every parameter within ADAM_FLIP_LR * lr, twice the most two Adam
# updates from zero moments can move (betas 0.5, 0.999: 1 and 1.054 lr);
# half the parameters within 0.01 lr (a split that lost gradients or
# statistics moves most of them by about lr); the BatchNorm statistics
# within 1e-2 of each tensor's largest magnitude. The 99th percentile of
# the parameters is printed (4.5e-2 to 5.4e-2 lr in two runs).
TOL_MESH_LOSS = 1e-3
ADAM_FLIP_LR = 4.2
MESH_MEDIAN_LR = 0.01
TOL_MESH_STATS = 1e-2


def write_idx(directory, n, seed):
    """MNIST's idx.gz pair of ``n`` uniform random 28x28 uint8 digits."""
    import gzip

    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    images = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    with gzip.open(os.path.join(directory, "train-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(np.array([2051, n, 28, 28], ">i4").tobytes() + images.tobytes())
    with gzip.open(os.path.join(directory, "train-labels-idx1-ubyte.gz"),
                   "wb") as f:
        f.write(np.array([2049, n], ">i4").tobytes() + labels.tobytes())


def data_phase(dev, card) -> dict:
    """Phase 47 (module docstring); returns the record's entry."""
    import numpy as np
    import torch

    from ganode_tpu_torch.build_rotmnist import main as build_rotmnist
    from ganode_tpu_torch.data import UCF101RandomClipSampler, pack_arrays
    from ganode_tpu_torch.data import transforms as tt
    from ganode_tpu_torch.data.frames import get_mean, get_std
    from ganode_tpu_torch.ops import fused_gru, fused_rk4
    from ganode_tpu_torch.train import runner
    from ganode_tpu_torch.utils.config import get_config

    t0 = time.perf_counter()
    phase(f"the data library: {ROTMNIST_DIGITS} idx digits -> python -m "
          "ganode_tpu_torch.build_rotmnist (in process) -> run_training "
          f"mnist_ode at full width ({DATA_STEPS} steps); a "
          "UCF101RandomClipSampler batch through the keyed transforms on the "
          "card against the CPU")
    tmp = tempfile.mkdtemp(prefix="ganode_data_")
    out = {}
    try:
        write_idx(os.path.join(tmp, "mnist"), ROTMNIST_DIGITS, 0)
        npz = os.path.join(tmp, "rot-mnist.npz")
        t1 = time.perf_counter()
        build_rotmnist(["--out", npz, "--mnist-dir", os.path.join(tmp, "mnist"),
                        "--num", str(ROTMNIST_DIGITS)])
        build_s = time.perf_counter() - t1
        with np.load(npz) as f:
            X, Y = f["X"], f["Y"]
        require(X.shape == (ROTMNIST_DIGITS, 16, 784) and X.min() >= 0.0
                and X.max() <= 1.0 + 1e-6 and Y.shape == (ROTMNIST_DIGITS,),
                f"rot-mnist.npz: X {X.shape} in [{X.min()}, {X.max()}]")
        cfg = get_config("mnist_ode", data_path=npz, **MESH_RUN)
        reset_counts()
        t1 = time.perf_counter()
        state, metrics = runner.run_training(
            cfg, os.path.join(tmp, "run"), steps=DATA_STEPS, device=dev)
        run_s = time.perf_counter() - t1
        k1, k2 = fused_rk4.launches, fused_gru.launches
        require(k1 == 6 * DATA_STEPS and k2 == 0 and state.step == DATA_STEPS
                and all(math.isfinite(v) for v in metrics.values()),
                f"mnist_ode from build_rotmnist: K1 {k1}, K2 {k2}, {metrics}")
        say(f"build_rotmnist: {ROTMNIST_DIGITS} clips of 16 frames in "
            f"{build_s:.2f} s (host); run_training mnist_ode (B="
            f"{cfg.batch_size}, ngf=ndf={cfg.ngf}) on it: {DATA_STEPS} steps "
            f"in {run_s:.2f} s, K1 {k1} (6 per step), K2 {k2}; losses "
            f"{metrics}; {card}")
        out.update(build_seconds=build_s, run_seconds=run_s, k1_launches=k1,
                   losses=metrics)

        rng = np.random.default_rng(1)
        videos = [rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
                  for n in (40, 24, 33, 50)]
        pack = pack_arrays(os.path.join(tmp, "pack"), videos, [0, 1, 2, 3],
                           source_fps=[30.0] * 4)
        sampler = UCF101RandomClipSampler(pack, 8, num_frames=16,
                                          frame_rate=15.0)
        clips, _ = sampler.sample(np.random.default_rng(2))
        g = torch.Generator().manual_seed(3)
        b = clips.shape[0]
        draws = {
            "flip": torch.rand(b, generator=g) < 0.5,
            "scale": torch.randint(0, 5, (b,), generator=g),
            "pos": torch.randint(0, 5, (b,), generator=g),
            "start": torch.randint(0, 16 - 8 + 1, (b,), generator=g)}
        crop = lambda s: int(64 * (1.0, 0.84, 0.71, 0.59, 0.5)[int(s)])
        draws["offsets"] = torch.stack([torch.stack([
            torch.randint(0, 64 - crop(s) + 1, (), generator=g)
            for _ in range(2)]) for s in draws["scale"]])

        def pipeline(x):
            x = tt.per_clip(tt.random_horizontal_flip, x,
                            draws={"flip": draws["flip"]})
            corner = tt.per_clip(
                functools.partial(tt.multi_scale_corner_crop, size=56), x,
                draws={"scale_idx": draws["scale"], "pos_idx": draws["pos"]})
            rand = tt.per_clip(
                functools.partial(tt.multi_scale_random_crop, size=56), x,
                draws={"scale_idx": draws["scale"],
                       "offsets": draws["offsets"]})
            window = tt.per_clip(
                functools.partial(tt.temporal_random_crop, size=8), corner,
                draws={"start": draws["start"]})
            norm = tt.normalize(window, get_mean(1.0), get_std(1.0))
            return {"flip": x, "corner": corner, "random": rand,
                    "window": window, "normalize": norm}

        x = torch.from_numpy(clips)
        t1 = time.perf_counter()
        on_card = pipeline(x.to(dev))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        on_cpu = pipeline(x)
        errs = {k: (on_card[k].cpu() - v).abs().max().item()
                for k, v in on_cpu.items()}
        require(errs["flip"] == 0.0 and errs["window"] <= TOL_TRANSFORM
                and all(e <= TOL_TRANSFORM for e in errs.values())
                and all(v.device.type == dev.type for v in on_card.values()),
                f"transforms card vs CPU: {errs}")
        say(f"UCF101RandomClipSampler (15 fps of 30, 8 clips of 16 frames "
            f"at 64x64x3) -> flip, multi-scale corner and random crops to "
            f"56, an 8-frame window, normalize, on the card in {card_s:.3f} "
            f"s: max|card - CPU| {errs} (tol {TOL_TRANSFORM}); {card}")
        out["transform_max_abs_err"] = errs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    say(f"data phase: {out['seconds']:.1f} s")
    return out


def module_tensors(state) -> dict:
    """The three nets' ``state_dict`` tensors by name, on the host."""
    return {f"{name}.{k}": v.detach().cpu().clone()
            for name in ("gen", "dis_img", "dis_vid")
            for k, v in getattr(state, name).module.state_dict().items()}


def checkpoint_tensors(path) -> dict:
    """A run's checkpoint blob as ``module_tensors`` names them."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=True)
    return {f"{name}.{k}": v for name in ("gen", "dis_img", "dis_vid")
            for k, v in blob[name]["module"].items()}


def one_step_diff(got: dict, want: dict, param_names, lr) -> dict:
    """After one step, N-way against single-process: the parameters' largest
    and 99th-percentile |diff| in units of lr, the statistics' largest
    |diff| over the tensor's largest magnitude."""
    import torch

    diffs, stats = [], 0.0
    for k, v in want.items():
        if not v.is_floating_point():
            continue
        d = (got[k].float() - v.float()).abs().reshape(-1)
        if k in param_names:
            diffs.append(d)
        else:
            stats = max(stats, d.max().item() / max(v.abs().max().item(),
                                                     1e-12))
    d = torch.cat(diffs)
    q = lambda f: torch.kthvalue(d, max(1, int(f * d.numel()))).values.item()
    return {"param_max_lr": d.max().item() / lr,
            "param_median_lr": q(0.5) / lr, "param_q99_lr": q(0.99) / lr,
            "stats_rel": stats}


def param_names(trainer) -> set:
    return {f"{name}.{k}" for name, m in (("gen", trainer.gen),
                                          ("dis_img", trainer.dis_img),
                                          ("dis_vid", trainer.dis_vid))
            for k, _ in m.named_parameters()}


def check_one_step(tag, first_loss, want_loss, diff):
    rel = max(abs(first_loss[k] - v) / abs(v) for k, v in want_loss.items())
    say(f"{tag} against single-process after one step: losses max rel "
        f"{rel:.3e} (tol {TOL_MESH_LOSS}); parameters max|diff| "
        f"{diff['param_max_lr']:.3f} lr (tol {ADAM_FLIP_LR}), median "
        f"{diff['param_median_lr']:.2e} lr (tol {MESH_MEDIAN_LR}), 99th "
        f"percentile {diff['param_q99_lr']:.2e} lr; BatchNorm statistics "
        f"{diff['stats_rel']:.2e} of their largest (tol {TOL_MESH_STATS})")
    require(rel <= TOL_MESH_LOSS and diff["param_max_lr"] <= ADAM_FLIP_LR
            and diff["param_median_lr"] <= MESH_MEDIAN_LR
            and diff["stats_rel"] <= TOL_MESH_STATS,
            f"{tag}: losses rel {rel}, {diff}")
    return {"loss_max_rel": rel, **diff}


def state_digest(state) -> dict:
    """A sha1 of every tensor of a state: modules, Adam moments, EMA."""
    import hashlib

    out = {}
    for name in ("gen", "dis_img", "dis_vid"):
        net = getattr(state, name)
        tensors = dict(net.module.state_dict())
        names = {p: k for k, p in net.module.named_parameters()}
        for p, st in net.opt.state.items():
            tensors.update({f"adam.{names[p]}.{m}": v for m, v in st.items()})
        for k, v in tensors.items():
            out[f"{name}.{k}"] = hashlib.sha1(
                v.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
    return out


def collectives(tally: dict) -> str:
    """'N all-reduces and M all-gathers' of a per-step ``comm.TALLY``."""
    return " and ".join(f"{tally.get(f'{op}_calls', 0):.0f} {op.replace('_', '-')}s"
                        for op in ("all_reduce", "all_gather"))


def timed_parallel_step(cfg, dev, mesh, n=2):
    """ms per N-way train_step (1 warm-up, then ``n`` synced steps on this
    rank) and the collective bytes and all-reduces per step."""
    import torch

    from ganode_tpu_torch.parallel import comm
    from ganode_tpu_torch.parallel.step import make_parallel_step
    from ganode_tpu_torch.train import runner

    tr = runner.build_trainer(cfg, device=dev)
    step, place_state, place_batch = make_parallel_step(tr, mesh)
    state = place_state(tr.init_state())
    images, videos = place_batch(*random_batches(cfg, dev, 3))
    g = torch.Generator(dev).manual_seed(4)
    step(state, images, videos, generator=g)
    torch.cuda.synchronize()
    comm.reset_tally()
    t0 = time.perf_counter()
    for _ in range(n):
        m = step(state, images, videos, generator=g)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    tally = {k: v / n for k, v in comm.TALLY.items()}
    return ms, tally, {k: float(v) for k, v in m.items()}


def mesh_child(kind: str, directory: str) -> int:
    """Phase 49's ranks, under ``torch.distributed.run``: 2 ranks of
    ``kind`` ("gloo") on the one card. Writes ``rank<r>.pt`` in
    ``directory``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from ganode_tpu_torch.ops import _build
    from ganode_tpu_torch.parallel import init_distributed

    dev = init_distributed(kind, "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    _build.load_library()
    try:
        out = mesh_rank(kind, directory, dev)
        torch.save(out, os.path.join(directory, f"rank{dist.get_rank()}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_rank(kind: str, directory: str, dev) -> dict:
    """One rank's part of phases 49 and 50 in an initialised process group:
    ``run_training`` on ``ucf_ode`` over ``data=<world>``, a timed N-way
    step and, over gloo, the EP step and the pipelined sampler."""
    import torch
    import torch.distributed as dist

    from ganode_tpu_torch.models.pipeline import pipelined_sample_videos
    from ganode_tpu_torch.models import generator_for_config
    from ganode_tpu_torch.ops import fused_rk4
    from ganode_tpu_torch.parallel import comm, make_mesh
    from ganode_tpu_torch.parallel.step import make_parallel_step
    from ganode_tpu_torch.train import runner
    from ganode_tpu_torch.utils.config import get_config

    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"device": str(dev), "backend": dist.get_backend()}
    cfg = get_config("ucf_ode", mesh=f"data={world}", **MESH_RUN)
    reset_counts()
    comm.reset_tally()
    t0 = time.perf_counter()
    state, metrics = runner.run_training(
        cfg, os.path.join(directory, f"run_{kind}"), steps=MESH_STEPS,
        synthetic=True, device=dev)
    torch.cuda.synchronize()
    out["run_seconds"] = time.perf_counter() - t0
    out["k1_launches"] = fused_rk4.launches
    out["metrics"] = metrics
    out["run_tally"] = dict(comm.TALLY)
    out["digest"] = state_digest(state)
    del state
    mesh = make_mesh(world, ("data",))
    base = get_config("ucf_ode")
    ms, tally, m = timed_parallel_step(base, dev, mesh)
    out.update(step_ms=ms, step_tally=tally, step_metrics=m)
    if kind == "gloo":
        # one EP step of mnist_moe_ode: 2 of its 4 experts per rank
        moe = get_config("mnist_moe_ode")
        tr = runner.build_trainer(moe, device=dev)
        ep = make_mesh(None, ("data", "expert"), shape=(1, world))
        step, place_state, place_batch = make_parallel_step(tr, ep)
        st = place_state(tr.init_state())
        ptr = step.__self__
        out["ep_local_experts"] = tuple(
            st.gen.module.motion.moe_fn.expert_w1.shape)
        m = step(st, *place_batch(*random_batches(moe, dev, 7)),
                 generator=torch.Generator(dev).manual_seed(11))
        out["ep_metrics"] = {k: float(v) for k, v in m.items()}
        tensors = module_tensors(st)
        for k in list(tensors):
            if k.rsplit(".", 1)[-1].startswith("expert_"):
                part = dict(st.gen.module.named_parameters())[
                    k[len("gen."):]].detach()
                tensors[k] = comm.all_gather(
                    part.contiguous(), ptr.expert_group).cpu()
        if rank == 0:
            out["ep_tensors"] = tensors
        del tr, st
        # a 2-stage pipelined sample_videos(64) of ucf_ode
        gen = generator_for_config(base, device=dev)
        pipe = make_mesh(world, ("pipe",))
        reset_counts()
        comm.reset_tally()
        t0 = time.perf_counter()
        videos, _ = pipelined_sample_videos(
            gen, gen.state_dict(), 64, pipe,
            generator=torch.Generator(dev).manual_seed(13))
        torch.cuda.synchronize()
        out["pp_seconds"] = time.perf_counter() - t0
        out["pp_k1_launches"] = fused_rk4.launches
        out["pp_bytes"] = comm.TALLY["bytes"]
        if rank == 0:
            out["pp_videos"] = videos.cpu()
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_phases(dev, card) -> dict:
    """Phases 48-50 (module docstring); returns the record's entry."""
    import torch
    import torch.distributed as dist
    from torch.func import functional_call

    from ganode_tpu_torch.parallel import init_distributed

    from ganode_tpu_torch.models import generator_for_config
    from ganode_tpu_torch.ops import fused_rk4
    from ganode_tpu_torch.train import runner
    from ganode_tpu_torch.utils.config import get_config

    t0 = time.perf_counter()
    phase("parallel layouts, the single-process references on the card "
          f"(cuDNN deterministic, TF32 off): run_training ucf_ode ({MESH_STEPS} "
          "steps, full width), one mnist_moe_ode step, sample_videos(64) of "
          "ucf_ode in eval mode; one timed ucf_ode step")
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = True, False
    tmp = tempfile.mkdtemp(prefix="ganode_mesh_")
    out = {}
    try:
        cfg = get_config("ucf_ode", **MESH_RUN)
        state, _ = runner.run_training(cfg, os.path.join(tmp, "single"),
                                       steps=MESH_STEPS, synthetic=True,
                                       device=dev)
        single_log = jsonl(os.path.join(tmp, "single", "metrics.jsonl"))
        del state
        ckpt0 = lambda run: os.path.join(tmp, run, "checkpoints", "0",
                                         "state.pt")
        single = checkpoint_tensors(ckpt0("single"))
        losses = lambda line: {k: line[k] for k in (
            "dis_img_loss", "dis_vid_loss", "gen_loss")}
        tr = runner.build_trainer(cfg, device=dev)
        names = param_names(tr)
        st = tr.init_state()
        images, videos = random_batches(cfg, dev, 3)
        g = torch.Generator(dev).manual_seed(4)
        tr.train_step(st, images, videos, generator=g)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(2):
            tr.train_step(st, images, videos, generator=g)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t1) * 1e3 / 2
        del tr, st
        moe = get_config("mnist_moe_ode")
        tr = runner.build_trainer(moe, device=dev)
        st = tr.init_state()
        m = tr.train_step(st, *random_batches(moe, dev, 7),
                          generator=torch.Generator(dev).manual_seed(11))
        moe_metrics = {k: float(v) for k, v in m.items()}
        moe_tensors = module_tensors(st)
        moe_names = param_names(tr)
        del tr, st
        gen = generator_for_config(cfg, device=dev).eval()
        with torch.no_grad():
            ref_videos, _ = functional_call(
                gen, gen.state_dict(), (64,),
                {"generator": torch.Generator(dev).manual_seed(13)})
        ref_videos = ref_videos.cpu()
        del gen
        torch.cuda.empty_cache()
        say(f"single process: {MESH_STEPS} run_training steps, losses "
            f"{[{k: l[k] for k in ('dis_img_loss', 'dis_vid_loss', 'gen_loss')} for l in single_log]}; "
            f"a ucf_ode step {single_ms:.1f} ms (B=32, synced); {card}")

        def against_single(tag, run):
            log = jsonl(os.path.join(tmp, run, "metrics.jsonl"))
            require([l["step"] for l in log] == list(range(MESH_STEPS)),
                    f"{tag}: metrics.jsonl {log}")
            return check_one_step(tag, losses(log[0]), losses(single_log[0]),
                                  one_step_diff(checkpoint_tensors(ckpt0(run)),
                                                single, names, cfg.lr))

        phase("parallel layouts over gloo, two ranks on the one card: python "
              "-m torch.distributed.run --nproc-per-node 2 chip_smoke.py "
              f"--mesh-child gloo (run_training ucf_ode mesh=data=2, "
              f"{MESH_STEPS} steps; a timed N-way step; one EP mnist_moe_ode "
              "step on (data=1, expert=2); a 2-stage pipelined "
              "sample_videos(64))")
        t1 = time.perf_counter()
        run_child([sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc-per-node", "2", os.path.join(REPO, "chip_smoke.py"),
                   "--mesh-child", "gloo", tmp], "the two gloo ranks")
        child_s = time.perf_counter() - t1
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        gloo = against_single("data=2 over gloo", "run_gloo")
        require(ranks[0]["digest"] == ranks[1]["digest"],
                "the two ranks' states differ: " + str(sorted(
                    k for k, v in ranks[0]["digest"].items()
                    if ranks[1]["digest"][k] != v)[:5]))
        require(ranks[0]["metrics"] == ranks[1]["metrics"],
                f"the ranks report different losses: {ranks[0]['metrics']}, "
                f"{ranks[1]['metrics']}")
        k1 = [r["k1_launches"] for r in ranks]
        require(k1 == [6 * MESH_STEPS] * 2, f"K1 per rank {k1}")
        say(f"data=2 over gloo: {MESH_STEPS} steps in {ranks[0]['run_seconds']:.1f} s "
            f"of rank 0 ({child_s:.1f} s of child processes); both ranks' "
            f"states ({len(ranks[0]['digest'])} tensors, Adam moments "
            f"included) and losses equal bit for bit; K1 per rank {k1} (6 per "
            f"step per rank); {card}")
        say(f"N-way step over gloo, 2 ranks of B=16 on one card: "
            f"{ranks[0]['step_ms']:.1f} / {ranks[1]['step_ms']:.1f} ms per step "
            f"(single process B=32: {single_ms:.1f} ms); per step and rank "
            f"{ranks[0]['step_tally']['bytes'] / 2 ** 20:.1f} MiB in "
            f"{collectives(ranks[0]['step_tally'])} (the gradients in one "
            f"flat all-reduce per update, an all-gather per BatchNorm, the "
            f"metrics), gloo's own on the card's tensors, "
            f"{ranks[0]['step_tally']['seconds'] * 1e3:.1f} / "
            f"{ranks[1]['step_tally']['seconds'] * 1e3:.1f} ms of each "
            f"rank's host time inside them; {card}")
        # EP
        require(ranks[0]["ep_local_experts"][0] == moe.moe_experts // 2
                and ranks[0]["ep_metrics"] == ranks[1]["ep_metrics"],
                f"EP step: experts per rank {ranks[0]['ep_local_experts']}, "
                f"metrics {ranks[0]['ep_metrics']}, {ranks[1]['ep_metrics']}")
        ep = check_one_step(
            f"EP mnist_moe_ode step on (data=1, expert=2), "
            f"{ranks[0]['ep_local_experts'][0]} of {moe.moe_experts} experts "
            "per rank,", ranks[0]["ep_metrics"], moe_metrics,
            one_step_diff(ranks[0]["ep_tensors"], moe_tensors, moe_names,
                          moe.lr))
        # PP
        p_err = (ranks[0]["pp_videos"] - ref_videos).abs().max().item()
        pk1 = [r["pp_k1_launches"] for r in ranks]
        require(p_err <= TOL_VIDEO and pk1 == [1, 1],
                f"pipelined sample_videos: max|diff| {p_err}, K1 {pk1}")
        say(f"2-stage pipelined_sample_videos(64) of ucf_ode (2 microbatches "
            f"of 512 frames, sends through pinned host memory): max|pipelined "
            f"- sample_videos| {p_err:.3e} (tol {TOL_VIDEO}); "
            f"{ranks[0]['pp_seconds']:.2f} s, {ranks[0]['pp_bytes'] / 2 ** 20:.1f} "
            f"MiB moved by rank 0; K1 per rank {pk1}; {card}")
        out["gloo"] = {
            "child_seconds": child_s, "run_seconds": ranks[0]["run_seconds"],
            "against_single": gloo, "k1_launches_per_rank": k1,
            "step_ms_per_rank": [r["step_ms"] for r in ranks],
            "single_step_ms": single_ms,
            "step_bytes_per_rank": ranks[0]["step_tally"]["bytes"],
            "step_collective_s_per_rank": [r["step_tally"]["seconds"]
                                           for r in ranks],
            "step_tally": ranks[0]["step_tally"],
            "ep": ep,
            "pp": {"max_abs_err": p_err, "seconds": ranks[0]["pp_seconds"],
                   "k1_launches_per_rank": pk1,
                   "bytes_rank0": ranks[0]["pp_bytes"]}}

        phase("NCCL, a group of one in this process (init_process_group "
              "at tcp://localhost:<a free port>): run_training ucf_ode "
              f"mesh=data=1, {MESH_STEPS} steps; a timed step")
        t1 = time.perf_counter()
        init_distributed("nccl", dev, init_method=f"tcp://localhost:"
                         f"{free_port()}", rank=0, world_size=1)
        try:
            one = mesh_rank("nccl", tmp, dev)
        finally:
            dist.destroy_process_group()
        child_s = time.perf_counter() - t1
        require(one["backend"] == "nccl", f"backend {one['backend']}")
        nccl = against_single("data=1 over NCCL", "run_nccl")
        require(one["k1_launches"] == 6 * MESH_STEPS,
                f"K1 {one['k1_launches']}")
        say(f"data=1 over NCCL: {MESH_STEPS} steps in {one['run_seconds']:.1f} s "
            f"({child_s:.1f} s with the group's set-up); K1 {one['k1_launches']}; a "
            f"step {one['step_ms']:.1f} "
            f"ms with {one['step_tally']['bytes'] / 2 ** 20:.1f} MiB in "
            f"{collectives(one['step_tally'])} over NCCL, "
            f"{one['step_tally']['seconds'] * 1e3:.1f} ms of host time to "
            f"enqueue them; {card}")
        out["nccl"] = {"child_seconds": child_s, "against_single": nccl,
                       "k1_launches": one["k1_launches"],
                       "step_ms": one["step_ms"],
                       "step_bytes": one["step_tally"]["bytes"],
                       "step_enqueue_s": one["step_tally"]["seconds"]}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = saved
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    say(f"parallel phases: {out['seconds']:.1f} s")
    return out


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
    ptxas = _build.ptxas_report(_build.build_log)
    for name, info in ptxas.items():
        say(f"  ptxas -v {name}: {info}")
    warp_kernels = {n: i for n, i in ptxas.items() if "_warp_kernel" in n}
    k3_tc = {n: i for n, i in ptxas.items() if "deconv_i8_kernel_tc" in n}
    k3_bytes = {n: i for n, i in ptxas.items() if "deconv_i8_kernel_bytes" in n}
    k3_kernels = {**k3_tc, **k3_bytes}
    require(len(warp_kernels) == 4 and len(k3_tc) == K3_TC_VARIANTS
            and len(k3_bytes) == K3_BYTES_VARIANTS and len(ptxas) == 6
            + K3_TC_VARIANTS + K3_BYTES_VARIANTS,
            f"ptxas reported {sorted(ptxas)}: want 2 warp kernels at 16 and 32 "
            f"lanes, 2 wide kernels, K3's {K3_TC_VARIANTS} tensor-core tiles "
            f"(N 64, 128 x K chunk 32, 128 channels) and its "
            f"{K3_BYTES_VARIANTS} bytes kernels ((k, s, p, Co) = (4, 2, 1, 3), "
            "(1, 1, 0, 1))")
    for name, info in {**warp_kernels, **k3_kernels}.items():
        require(info.get("spill_stores") == 0 and info.get("spill_loads") == 0,
                f"kernel {name} spills: {info}")

    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    # Weights scale as 1/sqrt(fan_in), as the model's initialisers have them
    # (0.4 and 0.3 at width 16), so trajectories stay O(1) at every width and
    # 1e-5 abs is a float32 bar, as in tests/test_torch_cuda.py.
    def rk4_inputs(b, d, h, t):
        return (randn(b, d), randn(d, h, scale=1.6 / d ** 0.5),
                randn(h, scale=0.1), randn(h, d, scale=1.6 / h ** 0.5),
                randn(d, scale=0.1), torch.linspace(0.0, 1.0, t))

    def gru_inputs(b, d, t):
        return (randn(b, d), randn(t, b, d), randn(d, 3 * d, scale=1.2 / d ** 0.5),
                randn(d, 3 * d, scale=1.2 / d ** 0.5), randn(3 * d, scale=0.1),
                randn(3 * d, scale=0.1))

    errs = {}  # (kernel, variant) -> worst max abs error
    phase("kernels vs plain versions, every variant")

    def hold(kernel, module, run, plain, shape, variant):
        before = module.launches_by_variant[variant]
        with torch.no_grad():
            got = run()
            torch.cuda.synchronize()
            want = plain()
        require(module.launches_by_variant[variant] == before + 1,
                f"{kernel} {variant} counter did not rise")
        err = (got - want).abs().max().item()
        say(f"{kernel} {variant} shape={shape}: max|kernel-plain| = {err:.3e} "
            f"(tol {TOL_TRAJ})")
        require(got.shape == want.shape and err < TOL_TRAJ,
                f"{tuple(got.shape)} vs {tuple(want.shape)}, err {err}")
        errs[kernel, variant] = max(errs.get((kernel, variant), 0.0), err)

    # B,D,H,T: serving, ragged, odd B (W=16); two at W=32; wide; serving forced wide
    for shape, forced in (((64, 16, 16, 16), None), ((5, 10, 16, 6), None),
                          ((1, 1, 1, 2), None), ((63, 16, 16, 16), None),
                          ((7, 20, 32, 5), None), ((3, 32, 32, 4), None),
                          ((33, 64, 200, 9), None), ((64, 16, 16, 16), "wide")):
        args = rk4_inputs(*shape)
        variant = forced or _build.choose_variant(shape[1], shape[2])[0]
        run = ((lambda: fused_rk4._launch(*args[:5], shape[3],
                                          fused_rk4.uniform_step(args[5]),
                                          variant=forced))
               if forced else (lambda: fused_rk4_motion(*args)))
        hold("K1 rk4_motion", fused_rk4, run,
             lambda: reference_rk4_motion(*args), shape, variant)
    # B,D,T: the same classes for K2
    for shape, forced in (((64, 16, 16), None), ((5, 10, 6), None),
                          ((1, 1, 1), None), ((63, 16, 16), None),
                          ((9, 24, 5), None), ((4, 32, 3), None),
                          ((9, 80, 5), None), ((64, 16, 16), "wide")):
        args = gru_inputs(*shape)
        variant = forced or _build.choose_variant(shape[1])[0]
        run = ((lambda: fused_gru._launch(*args, variant=forced)) if forced
               else (lambda: fused_gru_motion(*args)))
        hold("K2 gru_motion", fused_gru, run,
             lambda: reference_gru_motion(*args), shape, variant)

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
        for m in (fused_rk4, fused_gru):
            m.launches = 0
            m.launches_by_variant.update(warp=0, wide=0)
        videos, _ = sess.sample_videos(64)
        torch.cuda.synchronize()
        launches = counter.launches
        by_variant = dict(counter.launches_by_variant)
        other = (fused_gru if counter is fused_rk4 else fused_rk4).launches
        say(f"{config_name}: sample_videos(64) -> {tuple(videos.shape)} "
            f"channels-first; kernel launches {launches} {by_variant}, other "
            f"kernel {other}")
        require(by_variant["warp"] >= 1 and by_variant["wide"] == 0,
                f"{config_name} did not serve through the warp variant")
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

    k1_args = rk4_inputs(64, 16, 16, 16)
    k2_args = gru_inputs(64, 16, 16)
    k1_h = fused_rk4.uniform_step(k1_args[5])
    with torch.no_grad():
        k1_ms, k1_wide_ms, k1_turns = in_turns(
            lambda: fused_rk4._launch(*k1_args[:5], 16, k1_h, variant="warp"),
            lambda: fused_rk4._launch(*k1_args[:5], 16, k1_h, variant="wide"),
            200)
        k1_call_ms = events_ms(lambda: fused_rk4_motion(*k1_args), 200)
        k1_plain_ms = events_ms(lambda: reference_rk4_motion(*k1_args), 10)
        k2_ms, k2_wide_ms, k2_turns = in_turns(
            lambda: fused_gru._launch(*k2_args, variant="warp"),
            lambda: fused_gru._launch(*k2_args, variant="wide"), 200)
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
    turns = lambda runs: " / ".join(f"{r * 1e3:.2f}" for r in runs)
    say(f"K1 rk4_motion B=64 D=H=16 T=16: warp kernel {k1_ms * 1e3:.2f} us on "
        f"the device, wide {k1_wide_ms * 1e3:.2f} us (in turns "
        f"warp/wide/wide/warp: {turns(k1_turns)}); {k1_call_ms * 1e3:.2f} us "
        f"per wrapper call; plain {k1_plain_ms * 1e3:.1f} us; bound "
        f"{k1_bound * 1e3:.4f} us ({k1_by}); {card}")
    say(f"K2 gru_motion B=64 D=16 T=16: warp kernel {k2_ms * 1e3:.2f} us on "
        f"the device, wide {k2_wide_ms * 1e3:.2f} us (in turns "
        f"warp/wide/wide/warp: {turns(k2_turns)}); {k2_call_ms * 1e3:.2f} us "
        f"per wrapper call; plain {k2_plain_ms * 1e3:.1f} us; cuDNN nn.GRU "
        f"{k2_lib_ms * 1e3:.2f} us (max|nn.GRU-plain| {lib_err:.2e}); bound "
        f"{k2_bound * 1e3:.4f} us ({k2_by}); {card}")

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

    training = train_phases(dev, card, events_ms)
    resume_dir = tempfile.mkdtemp(prefix="ganode_resume_")
    sde_dir = tempfile.mkdtemp(prefix="ganode_sde_cli_")
    entry = {"cli": cli_phase(card, resume_dir, sde_dir)}
    entry["resume"] = resume_phase(card, resume_dir)
    # the mnist_sde command line ran beside them; phase 25 reads its run
    sde_cli = (sde_dir, wait_child("sde_cli")[1])
    entry["run_training"] = runner_phase(
        dev, card, "ucf_ode", RUNNER_STEPS,
        training["ucf_ode"]["tf32_on"]["ms_per_step"], 6)
    entry["run_training_native"] = runner_phase(
        dev, card, "ucf_ode", RUNNER_STEPS,
        training["ucf_ode"]["tf32_on"]["ms_per_step"], 6,
        python_path=entry["run_training"])
    entry["device_data_step"] = device_data_phase(dev, card)
    training["entry_point"] = entry
    wgan = wgan_phases(dev, card, events_ms)
    wgan["run_training"] = runner_phase(
        dev, card, "ucf_wgan_gp_128", WGAN_RUNNER_STEPS,
        wgan["ms_per_step"], 0)
    wgan["run_training_native"] = runner_phase(
        dev, card, "ucf_wgan_gp_128", WGAN_RUNNER_STEPS,
        wgan["ms_per_step"], 0, python_path=wgan["run_training"])
    training["ucf_wgan_gp_128"] = wgan
    training["ucf_ode_bf16"] = bf16_phase(
        dev, card, training["ucf_ode"]["tf32_on"]["ms_per_step"], events_ms)
    training["motion_variants"] = variant_phases(dev, card, events_ms, sde_cli)
    training["diffaug"] = diffaug_phases(dev, card, events_ms,
                                         wgan["ms_per_step"])
    training["leaky_relu_cost_ms"] = leaky_relu_phase(dev, card)
    training["gres"] = gres_phases(dev, card, events_ms)
    training["odegan"] = odegan_phases(dev, card, events_ms)
    evaluation = eval_phases(dev, card)
    int8 = int8_phases(dev, card)
    data = data_phase(dev, card)
    parallel = mesh_phases(dev, card)

    worst = lambda kernel: max(e for (k, _), e in errs.items() if k == kernel)
    record = {"kernels": [
        {"name": "rk4_motion", "route": "cuda", "variant": "warp",
         "source": "ganode_tpu_torch/csrc/motion_kernels.cu",
         "replaces": "ganode_tpu/ops/fused_rk4.py:106",
         "launches": entry["run_training"]["k1_launches"],
         "launches_by_path": {
             "serve ucf_ode sample_videos(64)": launches_k1,
             "train_step, per step": training["ucf_ode"]["k1_launches_per_step"],
             f"run_training ucf_ode, {RUNNER_STEPS} steps":
                 entry["run_training"]["k1_launches"],
             f"run_training ucf_ode through the native loader, "
             f"{RUNNER_STEPS} steps":
                 entry["run_training_native"]["k1_launches"],
             f"run_training ucf_wgan_gp_128 through the native loader, "
             f"{WGAN_RUNNER_STEPS} steps":
                 wgan["run_training_native"]["k1_launches"]},
         "max_abs_err": worst("K1 rk4_motion"),
         "ms": k1_ms, "ms_wide": k1_wide_ms, "call_ms": k1_call_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None,
         "training_launches_per_step": training["ucf_ode"]["k1_launches_per_step"],
         "backward_ms": training["ucf_ode"]["k1_backward_ms"]},
        {"name": "gru_motion", "route": "cuda", "variant": "warp",
         "source": "ganode_tpu_torch/csrc/motion_kernels.cu",
         "replaces": "ganode_tpu/ops/fused_gru.py:90",
         "launches": entry["device_data_step"]["k2_launches"],
         "launches_by_path": {
             "serve mnist_gru sample_videos(64)": launches_k2,
             "train_step, per step": training["mnist_gru"]["k2_launches_per_step"],
             f"device data step mnist_gru, {DEVICE_DATA_STEPS} steps":
                 entry["device_data_step"]["k2_launches"]},
         "max_abs_err": worst("K2 gru_motion"),
         "ms": k2_ms, "ms_wide": k2_wide_ms, "call_ms": k2_call_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": k2_lib_ms,
         "training_launches_per_step": training["mnist_gru"]["k2_launches_per_step"],
         "backward_ms": training["mnist_gru"]["k2_backward_ms"]},
    ], "max_abs_err_by_variant": {f"{k} {v}": e for (k, v), e in errs.items()},
        "serving_ms": serving, "training": training, "card": smi}
    # the SDE, CDE, ODE-RNN and MoE-ODE paths run neither kernel, as in JAX
    for kernel, key in zip(record["kernels"], ("k1", "k2")):
        for name, rec in training["motion_variants"].items():
            if name in VARIANTS:
                kernel["launches_by_path"][f"train_step {name}, per step"] = \
                    rec[f"{key}_launches_per_step"]
    # DiffAugment adds no motion solve: the ADA mnist_ode step launches K1 as
    # the unaugmented one does, and the augmented dopri5 path neither kernel
    aug = training["diffaug"]
    k1_paths = record["kernels"][0]["launches_by_path"]
    k1_paths["train_step mnist_ode + diffaug + ADA + R1, per step"] = \
        aug["mnist_ode_ada"]["ada"]["k1_launches_per_step"][0]
    k1_paths["train_step mnist_ode, per step"] = \
        aug["mnist_ode_ada"]["plain"]["k1_launches_per_step"][0]
    for kernel, key in zip(record["kernels"], ("k1", "k2")):
        kernel["launches_by_path"]["train_step ucf_wgan_gp_128 + diffaug, "
                                   f"{WGAN_DIFFAUG_STEPS} steps"] = \
            aug["ucf_wgan_gp_128_diffaug"][f"{key}_launches"]
    record["kernels"][1]["launches_by_path"][
        f"train_step mnist_ode + diffaug + ADA + R1, {2 * DIFFAUG_STEPS} "
        "steps"] = aug["mnist_ode_ada"]["ada"]["k2_launches"]
    # the GResBlock trunks keep the rk4 motion: K1 as on ucf_ode, K2 none
    for name, rec in training["gres"].items():
        k1_paths[f"train_step {name}, per step"] = rec["k1_launches_per_step"]
        k1_paths[f"serve {name} sample_videos(64)"] = \
            rec["serving"]["k1_launches"]
        record["kernels"][1]["launches_by_path"][
            f"train_step {name}, {GRES_STEPS} steps"] = rec["k2_launches"]
    # the ODE-GAN trainer's network steps over the ucf_ode triple: K1 once
    # per sample, K2 none
    for method in ODEGAN_METHODS:
        for net in ODEGAN_NETS:
            path = f"ODE-GAN {method} {net} step, ucf_ode"
            k1_paths[path] = training["odegan"][method]["k1_launches"][net]
        record["kernels"][1]["launches_by_path"][
            f"ODE-GAN {method} triple, ucf_ode"] = \
            training["odegan"][method]["k2_launches"]
    for kernel, key in zip(record["kernels"], ("K1 rk4_motion",
                                               "K2 gru_motion")):
        kernel["double_backward_max_rel_err"] = max(
            v for k, v in training["odegan"]["double_backward_err"].items()
            if k.startswith(key))
    # evaluation: K1 once per sampled 64-clip chunk of an ode config, none on
    # the dopri5 north star; K2 none
    cli = evaluation["evaluate_cli"]
    k1_paths[f"evaluate ucf_ode --n-samples {EVAL_CLI_SAMPLES}, per run"] = \
        cli["k1_launches"][0]
    record["kernels"][1]["launches_by_path"][
        f"evaluate ucf_ode --n-samples {EVAL_CLI_SAMPLES}, per run"] = \
        cli["k2_launches"][0]
    geo = evaluation["north_star_geometry"]
    for kernel, key in zip(record["kernels"], ("k1", "k2")):
        kernel["launches_by_path"][
            f"eval ucf_wgan_gp_128, {EVAL_FAKES} fakes"] = geo[f"{key}_launches"]
    record["evaluation"] = evaluation
    # the int8 serving trunk: K3 once per layer, K1 once per rk4 call, K2 none
    serving8 = int8["serving"]
    for name in INT8_CONFIGS:
        calls = serving8[name]["launches_per_call"]["dynamic"]
        for kernel, key in zip(record["kernels"], ("k1", "k2")):
            kernel["launches_by_path"][
                f"serve {name} int8 sample_videos(64)"] = calls[key]
    main_layers = int8["layers"]["ucf_ode"]
    costs = [deconv_i8_cost(*l["shape"]) for l in main_layers]
    t_ops = sum(c[0] for c in costs) / PEAK_INT8_OPS_S
    t_bytes = sum(c[1] for c in costs) / PEAK_BYTES_S
    layer_sum = lambda key, name="ucf_ode": sum(
        l[key] for l in int8["layers"][name])
    record["kernels"].append({
        "name": "deconv_i8", "route": "cuda",
        "variant": "tensor-core implicit GEMM (wgmma s8 over TMA tiles, "
                   "Co >= 8) and the bytes kernel (Co < 8)",
        "source": "ganode_tpu_torch/csrc/int8_deconv.cu",
        "replaces": "none: ganode_tpu/ops/quant.py:151 (_deconv_i8, XLA's "
                    "conv_general_dilated; no pallas_call)",
        "launches": serving8["ucf_ode"]["launches_per_call"]["dynamic"]["k3"],
        "launches_by_path": {
            f"serve {name} int8 {mode} sample_videos(64)":
                serving8[name]["launches_per_call"][mode]["k3"]
            for name in INT8_CONFIGS for mode in ("dynamic", "static")},
        "max_abs_err": int8["max_abs_err"],
        "ms": layer_sum("ms"), "plain_ms": layer_sum("plain_ms"),
        "bound_ms": layer_sum("bound_ms"),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "cudnn_bf16_ms": layer_sum("cudnn_bf16_ms"),
        "cudnn_tf32_ms": layer_sum("cudnn_tf32_ms"),
        "int_mm_ms_co_ge_8": sum(l["int_mm_ms"] or 0.0
                                 for l in int8["layers"]["ucf_ode"]),
        "ms_per_call_by_config": {name: layer_sum("ms", name)
                                  for name in INT8_CONFIGS},
        "bound_ms_by_config": {name: layer_sum("bound_ms", name)
                               for name in INT8_CONFIGS},
        "by_layer": int8["layers"]})
    record["int8_serving"] = {k: v for k, v in int8.items() if k != "layers"}
    # the data library's run and the parallel layouts: K1 6 per step in
    # every rank, once per rank in a pipelined sample; K2 none
    k1_paths[f"run_training mnist_ode from build_rotmnist, {DATA_STEPS} "
             "steps"] = data["k1_launches"]
    for r, n in enumerate(parallel["gloo"]["k1_launches_per_rank"]):
        k1_paths[f"run_training ucf_ode mesh=data=2 over gloo, {MESH_STEPS} "
                 f"steps, rank {r}"] = n
    for r, n in enumerate(parallel["gloo"]["pp"]["k1_launches_per_rank"]):
        k1_paths[f"pipelined_sample_videos(64) ucf_ode, 2 stages, rank {r}"] = n
    k1_paths[f"run_training ucf_ode mesh=data=1 over NCCL, {MESH_STEPS} "
             "steps"] = parallel["nccl"]["k1_launches"]
    record["data"] = data
    record["parallel"] = parallel
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-check"]:
        sys.exit(resume_check(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(sys.argv[2], sys.argv[3]))
    sys.exit(main())
