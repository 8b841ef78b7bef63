"""Build and bind the port's CUDA kernels (``csrc/motion_kernels.cu``).

The source has a plain C interface. It is compiled once, at first use, by
``nvcc`` into ``ganode_tpu_torch/_build/libganode_motion_<hash>.so`` (the hash
covers the source and the flags, so an edited source is rebuilt) and loaded
with ``ctypes``. The library is written under a temporary name and moved into
place with ``os.replace``, so concurrent builders never see a half-written file
and no lock file exists. Nothing here runs at import time.

A missing ``nvcc`` or a failed build raises with the compiler's output; there
is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "motion_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
        "CUDA toolkit is needed to build ganode_tpu_torch/csrc/motion_kernels.cu")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libganode_motion_{digest}.so"


def _compile(out: Path) -> str:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return log


def _bind(lib):
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ganode_rk4_motion.argtypes = [vp] * 6 + [i32] * 4 + [f32, vp]
    lib.ganode_rk4_motion.restype = i32
    lib.ganode_gru_motion.argtypes = [vp] * 7 + [i32] * 3 + [vp]
    lib.ganode_gru_motion.restype = i32
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
    if not path.exists():
        build_log = _compile(path)
    build_seconds = time.perf_counter() - t0
    _lib = _bind(ctypes.CDLL(str(path)))
    return _lib


def check_inputs(tensors: dict, shapes: dict):
    """Validate a kernel's inputs: each tensor has its shape (every size >= 1),
    is float32 and contiguous, and lies on the first tensor's device."""
    device = next(iter(tensors.values())).device
    for name, a in tensors.items():
        if tuple(a.shape) != shapes[name] or min(shapes[name]) < 1:
            raise ValueError(f"{name} must have shape {shapes[name]} (sizes >= 1), "
                             f"got {tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, the others on {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check(err: int, what: str):
    """Raise if a launcher returned non-zero."""
    if err != 0:
        msg = load_library().ganode_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed ({err}): {msg}")
