"""Input pipeline: bounded consumption, prefetch and device placement
(port of ``repro.data.pipeline``): ``DeviceBatcher`` places whole batches
on one device, ``ShardedBatcher`` gives each data-parallel worker its
slice of the global batch, as the reference's mesh sharding does, with
the host batches prefetched on a background thread (``Prefetcher``)."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class InfiniteStream:
    """Wrapper marking an iterator as EXPLICITLY unbounded.

    ``len(stream)`` raises ``TypeError``, and ``list(stream)`` raises
    ``RuntimeError`` up front instead of looping forever (CPython swallows
    ``TypeError`` from ``__length_hint__``, so the hint raises another
    type). Bound a stream with ``take(it, n)``.
    """

    def __init__(self, it: Iterator):
        self._it = iter(it)

    def __iter__(self) -> "InfiniteStream":
        return self

    def __next__(self):
        return next(self._it)

    def __len__(self) -> int:
        raise TypeError(
            "infinite stream: len() is undefined — bound it with "
            "repro_torch.data.take(it, n)"
        )

    def __bool__(self) -> bool:
        # without this, bool() falls back to the raising __len__
        return True

    def __length_hint__(self) -> int:
        raise RuntimeError(
            "infinite stream: list()/tuple() would never terminate — "
            "bound it with repro_torch.data.take(it, n)"
        )


class DeviceBatcher:
    """Moves each host (numpy) batch onto ``device`` as tensors.

    On CUDA the copy goes through pinned memory without blocking the
    host: a pageable copy would wait for every step already issued, and
    the driver's one-step-late loss drain relies on the host running
    ahead. (PyTorch's pinned-memory pool keeps the staging buffer until
    the copy has run.)"""

    def __init__(self, it: Iterator[dict], device):
        self._it = it
        self.device = torch.device(device)

    def _put(self, v) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(v))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def __iter__(self):
        for batch in self._it:
            yield {k: self._put(v) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of an iterator, at most ``depth`` items
    ahead. The thread starts at construction and is a daemon, so an
    abandoned stream does not keep the process alive. An exception the
    source raises is raised again where the consumer reaches it."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put((False, item))
        except Exception as e:  # handed to the consumer, raised there
            self._q.put((True, e))
        finally:
            self._q.put((False, self._done))

    def __iter__(self):
        return self

    def __next__(self):
        failed, item = self._q.get()
        if failed:
            raise item
        if item is self._done:
            self._q.put((False, self._done))  # every later next() stops too
            raise StopIteration
        return item


class ShardedBatcher(DeviceBatcher):
    """Each worker's share of a global batch stream: rank w of W takes the
    contiguous rows [w * B/W, (w+1) * B/W) of every array's leading
    (batch) axis, on its own ``device`` (the reference's ``ShardedBatcher``
    places the same slice on worker w's device). ``rank`` and ``world``
    default to the torch.distributed group's, else 0 and 1. The host
    batches are prefetched ``prefetch`` ahead on a background thread
    (0: none); slicing and the copy to the device stay on the consumer's
    thread.

    It typically wraps an unbounded stream, so ``len()`` and ``list()`` are
    guarded as ``InfiniteStream``'s: bound consumption with
    ``take(iter(b), n)``."""

    def __init__(self, it: Iterator[dict], device, rank=None, world=None,
                 prefetch: int = 2):
        super().__init__(Prefetcher(it, prefetch) if prefetch else it,
                         device)
        initialised = (torch.distributed.is_available()
                       and torch.distributed.is_initialized())
        if world is None:
            world = torch.distributed.get_world_size() if initialised else 1
        if rank is None:
            rank = torch.distributed.get_rank() if initialised else 0
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        self.rank, self.world = rank, world

    def __len__(self) -> int:
        raise TypeError(
            "ShardedBatcher wraps an (typically infinite) stream: len() "
            "is undefined — bound it with repro_torch.data.take(iter(b), n)"
        )

    def __bool__(self) -> bool:
        # without this, bool() falls back to the raising __len__
        return True

    def __length_hint__(self) -> int:
        raise RuntimeError(
            "ShardedBatcher wraps an (typically infinite) stream: list() "
            "may never terminate — bound it with "
            "repro_torch.data.take(iter(b), n)"
        )

    def _shard(self, v):
        v = np.asarray(v)
        if v.ndim == 0:
            return v
        if v.shape[0] % self.world:
            raise ValueError(
                f"global batch {v.shape[0]} does not divide over "
                f"{self.world} workers")
        n = v.shape[0] // self.world
        return v[self.rank * n:(self.rank + 1) * n]

    def __iter__(self):
        for batch in self._it:
            yield {k: self._put(self._shard(v)) for k, v in batch.items()}


def take(it: Iterator, n: int):
    """Yield the first ``n`` items, then stop — consuming EXACTLY ``n``
    from the underlying iterator."""
    it = iter(it)
    for _ in range(n):
        try:
            yield next(it)
        except StopIteration:
            return
