"""The native (C++) host runtime: a threaded, memory-mapped clip loader and
the sampler facades ``train/runner.py`` takes with ``data_loader="native"``
(twin of ``ganode_tpu.runtime``)."""
from .native import (
    NativeClipLoader,
    NativeClipSampler,
    NativeImageSampler,
    build_library,
)

__all__ = [
    "NativeClipLoader",
    "NativeClipSampler",
    "NativeImageSampler",
    "build_library",
]
