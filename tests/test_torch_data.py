"""The port's input pipeline guards and prefetch (``repro_torch.data``)
against the reference's (``tests/test_data_guards.py``):
``token_batches`` and ``ShardedBatcher`` wrap streams that never end, so
``len()`` and ``list()`` fail fast instead of hanging, ``take()`` is the
sanctioned bound, and the batcher's background prefetch gives the same
batches bit for bit as no prefetch (and as the reference's stream)."""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

from repro.data import token_batches as ref_token_batches
from repro_torch.data import (
    InfiniteStream,
    Prefetcher,
    ShardedBatcher,
    take,
    token_batches,
)


def test_token_batches_len_raises():
    it = token_batches(50, 2, 8, seed=0)
    assert isinstance(it, InfiniteStream)
    with pytest.raises(TypeError, match="take"):
        len(it)


def test_streams_stay_truthy():
    """bool() does not fall back to the raising __len__: ``if stream:``
    guards keep working."""
    assert bool(token_batches(50, 2, 8, seed=0))
    it = token_batches(50, 2, 8, seed=0)
    assert (it or None) is it
    b = ShardedBatcher(token_batches(50, 8, 4, seed=0), "cpu")
    assert (b or None) is b


def test_token_batches_list_fails_fast():
    with pytest.raises(RuntimeError, match="never terminate"):
        list(token_batches(50, 2, 8, seed=0))
    with pytest.raises(RuntimeError, match="never terminate"):
        tuple(token_batches(50, 2, 8, seed=0))


def test_take_and_islice_still_work():
    it = token_batches(50, 2, 8, seed=3)
    got = list(take(it, 3))
    assert len(got) == 3 and got[0]["tokens"].shape == (2, 8)
    more = list(itertools.islice(it, 2))
    assert len(more) == 2
    # take() consumes exactly its bound: the next item is the sixth
    raw = list(itertools.islice(iter(token_batches(50, 2, 8, seed=3)), 6))
    np.testing.assert_array_equal(next(it)["tokens"], raw[5]["tokens"])


@pytest.mark.parametrize("prefetch", [0, 2])
def test_sharded_batcher_guards(prefetch):
    b = ShardedBatcher(token_batches(50, 8, 4, seed=0), "cpu",
                       prefetch=prefetch)
    with pytest.raises(TypeError, match="take"):
        len(b)
    with pytest.raises(RuntimeError, match="never terminate"):
        list(b)
    one = next(iter(take(iter(b), 1)))
    assert one["tokens"].shape == (8, 4)


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2), (2, 4)])
def test_prefetch_gives_the_same_batches(rank, world):
    """With and without prefetch, the same batches bit for bit, each the
    rank's rows of the reference's stream."""
    runs = {p: list(take(iter(ShardedBatcher(
        token_batches(97, 8, 5, seed=11), "cpu", rank=rank, world=world,
        prefetch=p)), 5)) for p in (0, 2, 3)}
    ref = list(take(ref_token_batches(97, 8, 5, seed=11), 5))
    n = 8 // world
    for p, got in runs.items():
        assert len(got) == 5
        for b, want in zip(got, ref):
            assert b.keys() == want.keys()
            for k, v in want.items():
                assert b[k].dtype == torch.from_numpy(np.asarray(v)).dtype
                np.testing.assert_array_equal(
                    b[k].numpy(), np.asarray(v)[rank * n:(rank + 1) * n])


def test_prefetcher_ends_and_raises_where_the_consumer_reads():
    pf = Prefetcher(iter(range(5)), depth=2)
    assert list(pf) == [0, 1, 2, 3, 4]
    with pytest.raises(StopIteration):
        next(pf)  # an ended stream stays ended

    def failing():
        yield 1
        raise ValueError("source failed")

    pf = Prefetcher(failing(), depth=2)
    assert next(pf) == 1
    with pytest.raises(ValueError, match="source failed"):
        next(pf)
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()


def test_prefetchers_under_thread_switching_keep_every_item_in_order():
    """More prefetch threads than cores, consumed in turns, with a short
    switch interval: every stream yields all its items, in order."""
    n = len(os.sched_getaffinity(0)) + 1
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pfs = [Prefetcher(iter(range(i, i + 300)), depth=1)
               for i in range(n)]
        got = [[] for _ in range(n)]
        for items in zip(*pfs):
            for seen, item in zip(got, items):
                seen.append(item)
    finally:
        sys.setswitchinterval(old)
    assert got == [list(range(i, i + 300)) for i in range(n)]
    for pf in pfs:
        pf._thread.join(timeout=10)
        assert not pf._thread.is_alive()
