"""Keeping the device fed: ``prefetch`` stages an iterator's batches ahead
of the loop that consumes them (twin of ``ganode_tpu/data/loader.py``), and
``make_global_batch``, the multi-host feeding path onto a mesh.

A background thread runs the iterator, so the host's gather of batch i + 1
overlaps the device's work on batch i. Each item is a tuple, list or dict
(nested freely) whose numpy-array and tensor leaves become tensors on
``device``; other leaves pass through.

On the card the batches go through a ring of ``size + 1`` pinned host
buffers, allocated at the first item and reused: the worker copies a
batch into a free buffer, the consumer's thread issues its copy to the card
(``non_blocking``, on a side stream) as soon as the worker has it, one
batch ahead of the one it hands out, and hands out each batch with its
stream waiting on the copy's event (``record_stream`` keeps the memory
from being reused early). A buffer goes back to the worker only after its
copy's event has completed. Only the consumer's thread makes CUDA calls
that touch a stream; the worker pins memory and copies on the host.

On the CPU it is a queue of tensors ``size`` deep.

An exception raised by the iterator is raised again in the consumer at the
batch where it happened; the stream never ends early in silence. Closing
the generator (or leaving a ``for`` loop over it) stops the worker and
joins it.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from .. import resolve_device

_POLL_S = 0.1  # how often a blocked worker checks for a stop


class _End:
    """The iterator ran out."""


_LEAF = object()  # where a leaf was, in the structure a worker hands over


class _Failed:
    """The iterator raised ``exc``."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _leaves(item) -> list:
    """The array and tensor leaves of ``item``, in a fixed order."""
    if isinstance(item, (tuple, list)):
        return [leaf for x in item for leaf in _leaves(x)]
    if isinstance(item, dict):
        return [leaf for k in item for leaf in _leaves(item[k])]
    if isinstance(item, (np.ndarray, torch.Tensor)):
        return [item]
    return []


def _rebuild(item, leaves: Iterator):
    """``item`` with its array and tensor leaves taken from ``leaves``."""
    if isinstance(item, (tuple, list)):
        return type(item)(_rebuild(x, leaves) for x in item)
    if isinstance(item, dict):
        return {k: _rebuild(v, leaves) for k, v in item.items()}
    if isinstance(item, (np.ndarray, torch.Tensor)) or item is _LEAF:
        return next(leaves)
    return item


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _put(q: queue.Queue, msg, stop: threading.Event) -> bool:
    """Put ``msg`` on ``q`` unless a stop comes first -> whether it was put."""
    while not stop.is_set():
        try:
            q.put(msg, timeout=_POLL_S)
            return True
        except queue.Full:
            pass
    return False


def _take(q: queue.Queue, stop: threading.Event):
    """The next item of ``q``, or None once a stop comes."""
    while not stop.is_set():
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            pass
    return None


def _run(iterator, stage, out: queue.Queue, stop: threading.Event):
    """The worker: ``stage(item)`` of each item onto ``out`` (None from
    ``stage`` means a stop came), then the end or the failure."""
    try:
        for item in iterator:
            msg = stage(item)
            if msg is None or not _put(out, msg, stop):
                return
        _put(out, _End, stop)
    except BaseException as exc:  # handed to the consumer, raised there
        _put(out, _Failed(exc), stop)
    finally:
        close = getattr(iterator, "close", None)
        if close is not None:
            close()


def _start(iterator, stage, out, stop) -> threading.Thread:
    t = threading.Thread(target=_run, args=(iterator, stage, out, stop),
                         name="prefetch", daemon=True)
    t.start()
    return t


def _check(msg):
    """``msg`` unless it ends the stream: None at the end; raises a
    failure."""
    if msg is _End:
        return None
    if isinstance(msg, _Failed):
        raise msg.exc
    return msg


def prefetch(iterator, size: int = 2, device="cuda") -> Iterator:
    """Run ``iterator`` in a background thread, keeping up to ``size``
    batches staged ahead of the consumer, and yield each item with its
    array and tensor leaves as tensors on ``device`` (the card unless the
    CPU is asked for; without a card, asking for it raises)."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, not {size}")
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:      # the worker sets it in its thread
            device = torch.device("cuda", torch.cuda.current_device())
        return _prefetch_cuda(iter(iterator), size, device)
    return _prefetch_host(iter(iterator), size)


def _prefetch_host(iterator, size: int):
    out: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def stage(item):
        return _rebuild(item, iter([_as_tensor(x) for x in _leaves(item)]))

    worker = _start(iterator, stage, out, stop)
    try:
        while (item := _check(out.get())) is not None:
            yield item
    finally:
        stop.set()
        worker.join()


def _prefetch_cuda(iterator, size: int, device: torch.device):
    n_slots = size + 1
    buffers = [None] * n_slots        # per slot: its pinned tensors
    free: queue.Queue = queue.Queue()
    for slot in range(n_slots):
        free.put(slot)
    filled: queue.Queue = queue.Queue()  # (slot, item), at most n_slots
    stop = threading.Event()

    def stage(item):
        """In the worker: copy ``item``'s leaves into a free pinned slot."""
        slot = _take(free, stop)
        if slot is None:
            return None
        leaves = [_as_tensor(x) for x in _leaves(item)]
        bufs = buffers[slot]
        if bufs is None or [(b.shape, b.dtype) for b in bufs] != [
                (x.shape, x.dtype) for x in leaves]:
            torch.cuda.set_device(device)
            bufs = buffers[slot] = [
                torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                for x in leaves]
        for b, x in zip(bufs, leaves):
            b.copy_(x)
        return slot, _rebuild(item, iter([_LEAF] * len(leaves)))

    side = torch.cuda.Stream(device)
    issued = collections.deque()      # (slot, item, tensors, event)
    inflight = []                     # (slot, event) handed out, copying

    def release(wait: bool):
        """Give back the slots whose copies are done (all, if ``wait``)."""
        keep = []
        for slot, ev in inflight:
            if wait:
                ev.synchronize()
            if wait or ev.query():
                free.put(slot)
            else:
                keep.append((slot, ev))
        inflight[:] = keep

    def issue(block: bool) -> bool:
        """Start the copy of the worker's next batch -> whether one was
        there (``block``: wait for it; False also at the end)."""
        release(wait=False)
        try:
            msg = filled.get_nowait()
        except queue.Empty:
            if not block:
                return False
            release(wait=True)  # the worker may be waiting for a slot
            msg = filled.get()
        if msg is _End or isinstance(msg, _Failed):
            if not block:             # raised when its batch is due
                filled.put(msg)
                return False
            _check(msg)
            return False
        slot, item = msg
        with torch.cuda.stream(side):
            tensors = [b.to(device, non_blocking=True) for b in buffers[slot]]
            ev = torch.cuda.Event()
            ev.record(side)
        issued.append((slot, item, tensors, ev))
        return True

    worker = _start(iterator, stage, filled, stop)
    try:
        while issued or issue(block=True):
            slot, item, tensors, ev = issued.popleft()
            if not issued:
                issue(block=False)    # the next batch's copy, ahead
            inflight.append((slot, ev))
            current = torch.cuda.current_stream(device)
            current.wait_event(ev)
            for t in tensors:
                t.record_stream(current)
            yield _rebuild(item, iter(tensors))
    finally:
        stop.set()
        worker.join()


def make_global_batch(local_batch, sharding):
    """Assemble a process-local batch into the global batch placed by
    ``sharding`` (a ``parallel.Sharding``; the multi-host feeding path:
    each rank provides its stripe along the 'data'-split axis, in 'data'
    order) -> this rank's shard of it, as a ``DTensor``."""
    from ..parallel.mesh import from_process_local

    return from_process_local(local_batch, sharding)
