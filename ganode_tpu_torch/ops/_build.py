"""Build and bind the port's CUDA kernels (every ``csrc/*.cu``: K1 and K2 in
``motion_kernels.cu``, K3 in ``int8_deconv.cu``).

The sources have a plain C interface. At first use each is compiled by its
own ``nvcc -c``, all started together, and the objects are linked into one
``ganode_tpu_torch/_build/libganode_kernels_<hash>.so`` (the hash covers the
sources and the flags, so an edited source is rebuilt), loaded with
``ctypes``. The library is written under a temporary name and moved into
place with ``os.replace``, so concurrent builders never see a half-written file
and no lock file exists. Nothing here runs at import time.

A missing ``nvcc`` or a failed build raises with the compiler's output; there
is no fallback. What ``ptxas -v`` said of each kernel (registers, stack,
spills) is kept beside the library and read back by ``ptxas_report``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# K3 encodes its TMA descriptors with the driver's cuTensorMapEncodeTiled
LINK_FLAGS = ("-lcuda",)

# Set by load_library(): the ctypes handle, and what the build reported.
_lib = None
build_seconds: float | None = None
build_log = ""


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME / $CUDA_PATH, else the toolkit's
    default install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, $CUDA_PATH, /usr/local/cuda): the "
        "CUDA toolkit is needed to build the kernels in ganode_tpu_torch/csrc")


# Lane counts of the warp variants' row groups (a template parameter of each
# warp kernel in csrc/motion_kernels.cu).
WARP_LANES = (16, 32)


def choose_variant(*widths: int) -> tuple[str, int]:
    """The kernel variant for a row of these widths: ``("warp", W)``, W the
    fewest lanes in ``WARP_LANES`` that hold every width, else ``("wide", 0)``
    (shared-memory tiles, any width that fits a block)."""
    widest = max(widths)
    for lanes in WARP_LANES:
        if widest <= lanes:
            return "warp", lanes
    return "wide", 0


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libganode_kernels_{h.hexdigest()[:16]}.so"


def _run(procs: list) -> str:
    """Wait for every ``(cmd, Popen)`` and return their output; raise with
    the compiler's output if any failed."""
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _compile(out: Path) -> str:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    objs = [out.with_name(f"{out.stem}.{src.stem}.{tag}.o") for src in SOURCES]
    tmp = out.with_name(f"{out.name}.{tag}")
    try:
        log = _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
                    for src, obj in zip(SOURCES, objs)])
        _run([_start([nvcc, "-shared", "-o", str(tmp), *map(str, objs),
                      *LINK_FLAGS])])
        _log_path(out).write_text(log)
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return log


def _log_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def _bind(lib):
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ganode_rk4_motion_warp.argtypes = [vp] * 6 + [i32] * 4 + [f32, i32, vp]
    lib.ganode_rk4_motion_wide.argtypes = [vp] * 6 + [i32] * 4 + [f32, vp]
    lib.ganode_gru_motion_warp.argtypes = [vp] * 7 + [i32] * 4 + [vp]
    lib.ganode_gru_motion_wide.argtypes = [vp] * 7 + [i32] * 3 + [vp]
    for name in ("rk4_motion_warp", "rk4_motion_wide", "gru_motion_warp",
                 "gru_motion_wide"):
        getattr(lib, f"ganode_{name}").restype = i32
    lib.ganode_deconv_i8.argtypes = [vp, vp, vp, i32, vp, vp, vp, i32,
                                     ctypes.POINTER(i32), vp]
    lib.ganode_deconv_i8.restype = i32
    lib.ganode_error_string.argtypes = [i32]
    lib.ganode_error_string.restype = ctypes.c_char_p
    return lib


def load_library():
    """The bound kernel library, built on first call."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    path = library_path()
    t0 = time.perf_counter()
    if path.exists():
        log = _log_path(path)
        build_log = log.read_text() if log.exists() else ""
    else:
        build_log = _compile(path)
    build_seconds = time.perf_counter() - t0
    _lib = _bind(ctypes.CDLL(str(path)))
    return _lib


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> dict:
    """Per kernel (mangled name) what ``ptxas -v`` reported: ``registers``,
    ``stack``, ``spill_stores`` and ``spill_loads`` in bytes."""
    report, name = {}, None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            name = m.group(1)
            report[name] = {}
        elif name and (m := _FRAME.search(line)):
            report[name].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        elif name and (m := _REGS.search(line)):
            report[name]["registers"] = int(m.group(1))
    return report


def check_inputs(tensors: dict, shapes: dict):
    """Validate a kernel's inputs: each tensor has its shape (every size >= 1),
    is float32 and contiguous, and lies on the first tensor's device."""
    device = next(iter(tensors.values())).device
    for name, a in tensors.items():
        shape = shapes[name]
        if a.shape != shape or min(shape) < 1:
            raise ValueError(f"{name} must have shape {shape} (sizes >= 1), "
                             f"got {tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, the others on {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_current_device(device: torch.device):
    """Refuse tensors that do not lie on the current CUDA device: the
    launchers' ``<<<...>>>`` and their shared-memory query act on the CUDA
    runtime's current device, whatever the tensors' device. A refusal costs
    one ``cudaGetDevice`` per call, where a device guard would cost two
    ``cudaSetDevice``s."""
    current = torch.cuda.current_device()
    if device.index != current:
        raise ValueError(
            f"the tensors lie on {device} but the current CUDA device is "
            f"cuda:{current}; launch under torch.cuda.device({device.index})")


def raw_stream(device: torch.device) -> int:
    """The handle of the current CUDA stream on ``device``, for a launcher.
    The raw call PyTorch's own generated kernels use: a few hundred ns on the
    host, where ``torch.cuda.current_stream(device).cuda_stream`` builds a
    Python ``Stream`` object each call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, what: str):
    """Raise if a launcher returned non-zero."""
    if err != 0:
        msg = load_library().ganode_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed ({err}): {msg}")
