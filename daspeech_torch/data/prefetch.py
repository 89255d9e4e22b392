"""Background batch prefetching, and resuming an epoch at a batch index.

Counterpart of ``daspeech_tpu/data/prefetch.py``: a bounded-queue producer
thread overlaps host-side collation (TSV reads, zip-npy decode, padding)
and, when asked, the host-to-device copy with the consumer's device step.
``to_device`` here is a plain ``.to(device)`` on the producer thread; the
copy from pinned memory is later work.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator

import numpy as np
import torch

_SENTINEL = object()


class Prefetcher:
    """Iterate ``producer()`` items from a daemon thread, ``depth`` ahead."""

    def __init__(self, producer: Callable[[], Iterable], depth: int = 4):
        self.producer = producer
        self.depth = depth

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err = []

        def run():
            try:
                for item in self.producer():
                    q.put(item)
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item


def to_device(batch: Dict, device) -> Dict:
    """A collated batch (nested dicts of numpy arrays and scalars) as
    tensors on ``device``: floats keep their type, integer arrays become
    int64 (the index type of torch's gathers); scalars stay as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = to_device(v, device)
        elif isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            out[k] = t.to(device, torch.int64 if not t.is_floating_point()
                          else t.dtype)
        else:
            out[k] = v
    return out


def prefetch_epoch(batcher, epoch: int, depth: int = 4, to_device=None,
                   start: int = 0):
    """Prefetched (spec, collated-batch) stream for one epoch of a
    ``BucketBatcher``-style iterator, from batch ``start`` on (the
    iterator position a checkpoint saved; the batches before it are
    neither collated nor transferred).

    ``to_device``: optional host->device transfer applied on the PRODUCER
    thread, so the copy of batch i+1 overlaps the consumer's step on
    batch i."""

    def produce():
        for spec, idxs in batcher.batches_for_epoch(epoch)[start:]:
            batch = batcher.collate(spec, idxs)
            if to_device is not None:
                batch = to_device(batch)
            yield spec, batch

    return Prefetcher(produce, depth=depth)
