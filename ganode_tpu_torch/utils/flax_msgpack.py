"""Read and write flax's msgpack parameter files with the standard library.

``flax.serialization.to_bytes`` writes a params tree as msgpack: nested maps
with string keys, each array leaf an extension object of type 1 whose
payload is itself the msgpack triple ``(shape, dtype name, C-order bytes)``;
a numpy scalar is type 3 with the same payload. This module reads and
writes that subset (reading any plain msgpack value besides) with
``struct`` alone, so the port shares the JAX
package's feature-model files (``eval_assets/``) byte for byte without the
``msgpack`` package or flax:

    tree = loads(data)     # nested dicts of numpy arrays
    data = dumps(tree)     # equal to flax's to_bytes for the same tree

``dumps`` writes each map in the order it is given; flax's params trees come
out of jax with their keys sorted, which is the order ``sort_keys`` gives.
flax splits an array above 2**30 bytes into chunks; such a file is refused
here, as is a bfloat16 leaf (numpy has no such dtype).
"""
from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------- writer
def _header(n: int, fix: int, fix_max: int, codes, out: bytearray):
    """A length header: the fixed form below ``fix_max``, else the 8-, 16-
    or 32-bit form in ``codes`` (None where the type has no 8-bit form)."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack's 32-bit length")


def _int(v: int, out: bytearray):
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit 64 bits")
    else:
        for code, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                 (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit 64 bits")


def _str(s: str, out: bytearray):
    b = s.encode("utf-8")
    _header(len(b), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
    out += b


def _bin(b: bytes, out: bytearray):
    _header(len(b), 0, 0, (0xc4, 0xc5, 0xc6), out)
    out += b


def _ext(code: int, payload: bytes, out: bytearray):
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(payload) in fixed:
        out.append(fixed[len(payload)])
    else:
        _header(len(payload), 0, 0, (0xc7, 0xc8, 0xc9), out)
    out += struct.pack(">b", code)
    out += payload


def _ndarray_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct or a.dtype.names:
        raise ValueError(f"dtype {a.dtype} cannot be written")
    if a.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {a.nbytes} bytes is above flax's "
                         f"{MAX_CHUNK_SIZE}-byte chunk size; chunked arrays "
                         "are not supported")
    out = bytearray()
    _header(3, 0x90, 16, (None, 0xdc, 0xdd), out)
    _header(a.ndim, 0x90, 16, (None, 0xdc, 0xdd), out)
    for n in a.shape:
        _int(int(n), out)
    _str(a.dtype.name, out)
    _bin(a.tobytes("C"), out)
    return bytes(out)


def _pack(x, out: bytearray):
    if isinstance(x, dict):
        _header(len(x), 0x80, 16, (None, 0xde, 0xdf), out)
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, not {type(k).__name__}")
            _str(k, out)
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        _ext(EXT_NDARRAY, _ndarray_payload(x), out)
    elif isinstance(x, np.generic):
        _ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(x)), out)
    else:
        raise TypeError(f"cannot write a {type(x).__name__}: a params "
                        "tree holds numpy arrays and scalars")


def dumps(tree) -> bytes:
    """A tree of dicts (str keys) with numpy arrays and numpy scalars as
    leaves -> flax msgpack bytes."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def sort_keys(tree):
    """The tree with every map's keys in sorted order, as jax rebuilds
    dicts (and so as flax writes its params)."""
    if isinstance(tree, dict):
        return {k: sort_keys(tree[k]) for k in sorted(tree)}
    return tree


# --------------------------------------------------------------------- reader
class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
                 0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
                 0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
                 0xdc: (">H", "array"), 0xdd: (">I", "array"),
                 0xde: (">H", "map"), 0xdf: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                   0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unsupported msgpack byte 0x{b:02x} at {self.pos - 1}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError("a chunked array (one leaf above 2**30 bytes) "
                             "is not supported")
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            a = _ndarray_from_payload(payload)
            return a[()] if code == EXT_NPSCALAR else a
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray_from_payload(payload: bytes) -> np.ndarray:
    r = _Reader(payload)
    shape, name, buf = r.value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported (numpy has no "
                         "bfloat16)")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def loads(data: bytes):
    """flax msgpack bytes -> the tree (dicts of numpy arrays)."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack value")
    return tree


def read(path: str):
    with open(path, "rb") as f:
        return loads(f.read())


def write(path: str, tree) -> None:
    with open(path, "wb") as f:
        f.write(dumps(tree))
