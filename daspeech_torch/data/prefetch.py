"""Background batch prefetching, the host-to-device copy, and resuming an
epoch at a batch index.

Counterpart of ``daspeech_tpu/data/prefetch.py``: a bounded-queue producer
thread overlaps host-side collation (TSV reads, zip-npy decode, padding)
and, when asked, the host-to-device copy with the consumer's device step.

On a CUDA device :func:`to_device` stages a batch's arrays in a pinned
host buffer and copies them with ``non_blocking=True`` on a side stream,
so the copy runs beside the step (the GPU's counterpart of the JAX CLI's
packed transfer, ``daspeech_tpu/cli/train.py:456-537``). The pinned
buffers are a small ring, reused in turn once their last copy has ended:
page-locking fresh memory for every array costs more than the copy
(measured on an H100 host by ``chip_smoke.py``: 0.40 GB/s, against 3.7
for a plain copy from pageable memory).
The consumer must call :func:`consume` on each batch before using it: its
stream then waits for the copy, and the caching allocator is told that the
consumer's stream uses the memory (``record_stream``), so that it is not
handed out again while the step still reads it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()

# host->device copies through the pinned path (``to_device`` on a CUDA
# device); the card smoke run reads it
COPIES = {"pinned": 0}
ALIGN = 256               # bytes; each array's offset in a staging buffer
STAGING_SLOTS = 3         # pinned buffers a device's copies rotate through


class Prefetcher:
    """Iterate ``producer()`` items from a daemon thread, ``depth`` ahead.
    Closing the iterator (or dropping it) stops the thread at its next
    item."""

    def __init__(self, producer: Callable[[], Iterable], depth: int = 4):
        self.producer = producer
        self.depth = depth

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            try:
                for item in self.producer():
                    if not put(item):
                        return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            put(_SENTINEL)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()


class DeviceBatch(dict):
    """A batch moved by :func:`to_device` on a CUDA device: its tensors and
    the event recorded on the copy stream after the copies."""
    ready: Optional[torch.cuda.Event] = None


def _tensors(batch: Dict):
    for v in batch.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        elif isinstance(v, torch.Tensor):
            yield v


def _arrays(batch: Dict, prefix=()):
    for k, v in batch.items():
        if isinstance(v, dict):
            yield from _arrays(v, prefix + (k,))
        elif isinstance(v, np.ndarray):
            yield prefix + (k,), v


def _widen(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_floating_point() else t.to(torch.int64)


def staging_bytes(batch: Dict) -> int:
    """Bytes of a staging buffer that holds ``batch``'s arrays, each at an
    ALIGN-byte offset."""
    return sum(-(-a.nbytes // ALIGN) * ALIGN for _, a in _arrays(batch))


def stage(batch: Dict, buf: torch.Tensor):
    """Copy ``batch``'s arrays into the uint8 host buffer ``buf``: a list
    of (path, host tensor) views of ``buf``, in the arrays' dtypes and
    shapes, each at an ALIGN-byte offset."""
    views, off = [], 0
    for path, a in _arrays(batch):
        src = torch.from_numpy(np.ascontiguousarray(a))
        view = buf[off: off + a.nbytes].view(src.dtype).view(src.shape)
        view.copy_(src)
        views.append((path, view))
        off += -(-a.nbytes // ALIGN) * ALIGN
    return views


def _rebuild(batch: Dict, moved, out: Dict) -> Dict:
    """``out`` holding ``batch`` with its arrays replaced by ``moved``
    (path -> tensor); scalars stay as they are."""
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = _rebuild(v, {p[1:]: t for p, t in moved.items()
                                  if p[0] == k}, {})
        elif isinstance(v, np.ndarray):
            out[k] = moved[(k,)]
        else:
            out[k] = v
    return out


class PinnedStaging:
    """The pinned host buffers of one device's copies: STAGING_SLOTS
    buffers used in turn, each grown to the largest batch it has held; a
    buffer is refilled only after the copy that last read it has ended
    (its event). Thread-safe: the prefetch thread and the main thread
    (validation) may both copy."""

    def __init__(self, device, slots: int = STAGING_SLOTS):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.buffers: list = [None] * slots
        self.events: list = [None] * slots
        self.turn = 0
        self.lock = threading.Lock()

    def copy(self, batch: Dict) -> "DeviceBatch":
        with self.lock:
            slot = self.turn
            self.turn = (slot + 1) % len(self.buffers)
            if self.events[slot] is not None:
                self.events[slot].synchronize()
            need = staging_bytes(batch)
            if self.buffers[slot] is None or self.buffers[slot].numel() < need:
                self.buffers[slot] = torch.empty(need, dtype=torch.uint8,
                                                 pin_memory=True)
            views = stage(batch, self.buffers[slot])
            with torch.cuda.stream(self.stream):
                moved = {p: _widen(v.to(self.device, non_blocking=True))
                         for p, v in views}
                ready = torch.cuda.Event()
                ready.record(self.stream)
            self.events[slot] = ready
        out = _rebuild(batch, moved, DeviceBatch())
        out.ready = ready
        COPIES["pinned"] += 1
        return out


_STAGING: Dict = {}


def to_device(batch: Dict, device) -> Dict:
    """A collated batch (nested dicts of numpy arrays and scalars) as
    tensors on ``device``: floats keep their type, integer arrays become
    int64 (the index type of torch's gathers); scalars stay as they are.

    On a CUDA device the arrays go through the device's
    :class:`PinnedStaging` ring (pinned, then copied with
    ``non_blocking=True`` on its side stream; integer arrays widened to
    int64 there, after the copy); the result is a :class:`DeviceBatch`
    whose ``ready`` event follows the copies: hand it to :func:`consume`
    before use. On the CPU nothing is pinned (a CPU-only torch cannot)."""
    device = torch.device(device)
    if device.type != "cuda":
        moved = {p: _widen(torch.from_numpy(a).to(device))
                 for p, a in _arrays(batch)}
        return _rebuild(batch, moved, {})
    if device not in _STAGING:
        _STAGING[device] = PinnedStaging(device)
    return _STAGING[device].copy(batch)


def consume(batch: Dict) -> Dict:
    """Make ``batch`` safe to use on the current stream: wait for its copy
    (the current stream waits on the copy stream's event; the host does
    not block) and record the current stream on each tensor for the caching
    allocator. A batch that was not moved by the pinned path is returned
    as it is."""
    if isinstance(batch, DeviceBatch) and batch.ready is not None:
        current = torch.cuda.current_stream(batch.ready.device)
        current.wait_event(batch.ready)
        for t in _tensors(batch):
            t.record_stream(current)
        batch.ready = None
    return batch


def prefetch_epoch(batcher, epoch: int, depth: int = 4, to_device=None,
                   start: int = 0):
    """Prefetched (spec, collated-batch) stream for one epoch of a
    ``BucketBatcher``-style iterator, from batch ``start`` on (the
    iterator position a checkpoint saved; the batches before it are
    neither collated nor transferred).

    ``to_device``: optional host->device transfer applied on the PRODUCER
    thread, so the copy of batch i+1 overlaps the consumer's step on
    batch i (pass each batch through :func:`consume` before use)."""

    def produce():
        for spec, idxs in batcher.batches_for_epoch(epoch)[start:]:
            batch = batcher.collate(spec, idxs)
            if to_device is not None:
                batch = to_device(batch)
            yield spec, batch

    return Prefetcher(produce, depth=depth)
