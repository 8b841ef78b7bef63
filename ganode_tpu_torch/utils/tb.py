"""TensorBoard event files without tensorboard or tensorflow (the port's own
copy of ``ganode_tpu/utils/tb.py``, which imports no JAX), and a reader of
the same framing.

The writer appends TFRecord-framed ``Event`` protos, encoded by hand, which
is all ``tensorboard --logdir`` needs to plot scalars. The reader checks the
framing and decodes the scalars back, so a run can be checked where no
tensorboard package is installed.

Wire level (both stable, version-frozen formats):
  * TFRecord frame:  u64 length | masked crc32c(length) | payload | masked
    crc32c(payload), crc mask = rotl-15 + 0xa282ead8.
  * Event proto:     1: wall_time (double), 2: step (int64),
                     3: file_version (string, first record only),
                     5: summary { repeated 1: value { 1: tag (string),
                     2: simple_value (float) } }.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterable, Iterator, List, Tuple, Union

# --------------------------------------------------------------------- crc32c
# Castagnoli polynomial (reflected): the TFRecord framing checksum.
_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------ proto encoding
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _field_bytes(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _field_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _field_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _field_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(wall_time: float, step: int,
                  scalars: Iterable[Tuple[str, float]]) -> bytes:
    values = b"".join(
        _field_bytes(1, _field_bytes(1, tag.encode("utf-8"))
                     + _field_float(2, float(value)))
        for tag, value in scalars)
    return (_field_double(1, wall_time) + _field_varint(2, int(step))
            + _field_bytes(5, values))


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


# ---------------------------------------------------------------- the writer
class EventWriter:
    """Append-only scalar event writer: ``add_scalar(s)`` / ``flush`` / ``close``.

    One instance owns one ``events.out.tfevents.*`` file under ``logdir``
    (created if needed). All writes are synchronous file appends: a few
    floats every logged step do not justify a writer thread.
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = "events.out.tfevents.%d.%s" % (int(time.time()),
                                              socket.gethostname())
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._record(_version_event(time.time()))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: Union[float, int], step: int,
                   wall_time: float | None = None) -> None:
        self.add_scalars({tag: value}, step, wall_time=wall_time)

    def add_scalars(self, scalars: Dict[str, Union[float, int]], step: int,
                    wall_time: float | None = None) -> None:
        """One Event carrying every (tag, value) pair at this step."""
        self._record(_scalar_event(wall_time or time.time(), step,
                                   scalars.items()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


# ---------------------------------------------------------------- the reader
def read_records(path: str) -> Iterator[bytes]:
    """The payloads of a TFRecord file, in order. Raises ValueError on a
    truncated record or a checksum that does not match."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at byte {pos}")
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if crc != _masked_crc(header):
            raise ValueError(f"{path}: bad length checksum at byte {pos}")
        start, end = pos + 12, pos + 12 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated record at byte {pos}")
        payload = data[start:end]
        (crc,) = struct.unpack("<I", data[end:end + 4])
        if crc != _masked_crc(payload):
            raise ValueError(f"{path}: bad payload checksum at byte {pos}")
        yield payload
        pos = end + 4


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return out, pos


def _fields(buf: bytes) -> Iterator[Tuple[int, object]]:
    """(field number, value) of each field of a proto message: an int for a
    varint, bytes for a length-delimited field, a float for fixed64 (double)
    and fixed32 (float)."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            (value,) = struct.unpack("<d", buf[pos:pos + 8])
            pos += 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            (value,) = struct.unpack("<f", buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, value


def read_scalars(path: str) -> Tuple[str, List[Tuple[int, Dict[str, float]]]]:
    """-> (the file version, ``[(step, {tag: value}), ...]`` for each event
    that carries scalars), from a file ``EventWriter`` wrote."""
    version, events = "", []
    for payload in read_records(path):
        step, scalars = 0, {}
        for field, value in _fields(payload):
            if field == 2:
                step = value
            elif field == 3:
                version = value.decode("utf-8")
            elif field == 5:
                for vf, v in _fields(value):
                    if vf != 1:
                        continue
                    parts = dict(_fields(v))
                    scalars[parts[1].decode("utf-8")] = parts.get(2, 0.0)
        if scalars:
            events.append((step, scalars))
    return version, events
