"""The port's flat sync at bf16 wire values over three workers (a 3-rank
gloo group on the CPU) against the reference's at W = 3, which runs
in-process under ``jax.vmap(..., axis_name="data")``.

With three workers a column can take three workers' terms, and then the
densify's form decides the bits: the reference's one-hot einsum
(``argmax_onehot`` at k <= ``argmax_k_limit``, ``threshold_onehot``) sums
them in float32 and rounds once to bf16, its scatter (``topk_scatter``,
``argmax_onehot`` above its limit) rounds after each add. The workers'
gradients share a common part, so that their selections overlap and most
selected columns take all three terms.

The three gloo processes start once for this file (the ``runs`` fixture):
each rank runs both sync paths x both wires x every selection on its own
inputs (made with numpy from a seed and the rank) and saves what it got.
The tests compare:

* a sparse leaf's update bit for bit; the dense leaves' update (a
  float32 all-reduce) and the memory (u - own, float32) within 1e-6, the
  reference's FMA allowance on ``m + eta*g``; bytes equal;
* packed == unpacked bit for bit, and the three ranks' updates bit for
  bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import buckets as rbk
from repro.core.distributed import SyncConfig as RefSyncConfig
from repro.core.distributed import bucketed_message_bytes as ref_bucket_bytes
from repro.core.distributed import bucketed_sync_gradients as ref_bucketed
from repro.core.distributed import message_bytes as ref_leaf_bytes
from repro.core.distributed import sparse_sync_gradients as ref_leaf
from repro_torch.convert import params_from_jax
from repro_torch.utils.tree import tree_leaves

W = 3
ETA = 0.3
COLS = 512
COL_AXES = {"w1": 0, "w2": 1, "blk": {"z": 1, "v": None}, "b": None,
            "s": None}
# (selection, argmax_k_limit): each densify form; argmax_onehot at a limit
# of 1 takes the scatter on every leaf with k > 1 and on the bucket (k 10)
SELECTIONS = {"argmax_onehot": ("argmax_onehot", 64),
              "argmax_onehot above its limit": ("argmax_onehot", 1),
              "threshold_onehot": ("threshold_onehot", 64),
              "topk_scatter": ("topk_scatter", 64)}
CASES = [(path, wire, sel) for path in ("bucketed", "per-leaf")
         for wire in ("unpacked", "packed") for sel in SELECTIONS]


def _tree_np(seed, common=None):
    rng = np.random.default_rng(seed)

    def f32(*s):
        return rng.standard_normal(s).astype(np.float32)

    tree = {"w1": f32(128, 256), "w2": f32(3, 64, 100),
            "blk": {"z": f32(90, 200), "v": f32(60, 300)},
            "b": f32(64), "s": f32(8, 16)}
    if common is None:
        return tree
    return jax.tree.map(lambda c, x: c + np.float32(0.3) * x, common, tree)


def _inputs(path, rank):
    """This rank's (memory, grads) as numpy: a common gradient plus this
    rank's part, and a small memory (a tree, or the plan's buffers)."""
    grads = _tree_np(10 + rank, common=_tree_np(9))
    if path == "per-leaf":
        return jax.tree.map(lambda x: 0.1 * x, _tree_np(20 + rank)), grads
    from repro_torch.core import buckets as bk

    plan = bk.make_plan(params_from_jax(grads), cols=COLS)
    rng = np.random.default_rng(30 + rank)
    return [(0.1 * rng.standard_normal(s.shape)).astype(np.float32)
            for s in plan.buckets], grads


def _cfg(path, wire, sel, cls=None):
    from repro_torch.core.distributed import SyncConfig

    selection, limit = SELECTIONS[sel]
    kw = dict(ratio=0.02, bucketed=path == "bucketed", bucket_cols=COLS,
              wire=wire, value_dtype="bfloat16", selection=selection,
              argmax_k_limit=limit)
    if cls is RefSyncConfig:
        return RefSyncConfig(**kw, _warn=False)
    return SyncConfig(**kw)


def _worker(rank, tmp):
    """One gloo rank: every sync case; saves its results."""
    import torch.distributed as dist

    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import (bucketed_sync_gradients,
                                              sparse_sync_gradients)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=W)
    out = {}
    try:
        for path, wire, sel in CASES:
            mem_np, grads_np = _inputs(path, rank)
            grads = params_from_jax(grads_np)
            cfg = _cfg(path, wire, sel)
            if path == "bucketed":
                plan = bk.make_plan(grads, cols=COLS)
                upd, mem, nbytes = bucketed_sync_gradients(
                    cfg, plan, [torch.from_numpy(m) for m in mem_np], grads,
                    ETA)
                mem = list(mem)
            else:
                upd, mem, nbytes = sparse_sync_gradients(
                    cfg, params_from_jax(mem_np), grads, ETA, COL_AXES)
                mem = tree_leaves(mem)
            out[(path, wire, sel)] = (tree_leaves(upd), mem, nbytes)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, from one 3-process gloo run for the file."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path_factory.mktemp("gloo3"))
    mp.spawn(_worker, args=(tmp,), nprocs=W, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(W)]


def _reference(path, sel):
    """The reference's W = 3 sync under vmap over the worker axis on the
    packed wire (its two wires give the same bits): (update leaves per
    worker, memory leaves per worker, bytes of each wire)."""
    rcfg = {w: _cfg(path, w, sel, RefSyncConfig)
            for w in ("packed", "unpacked")}
    mems, grads = zip(*(_inputs(path, r) for r in range(W)))
    stack = lambda *xs: jnp.stack([jnp.asarray(x) for x in xs])  # noqa
    g = jax.tree.map(stack, *grads)
    if path == "bucketed":
        plan = rbk.make_plan(jax.tree.map(jnp.asarray, grads[0]), cols=COLS)
        m = tuple(stack(*bs) for bs in zip(*mems))
        fn = lambda m, g: ref_bucketed(  # noqa: E731
            rcfg["packed"], plan, m, g, jnp.float32(ETA))[:2]
        nbytes = {w: ref_bucket_bytes(c, plan) for w, c in rcfg.items()}
    else:
        m = jax.tree.map(stack, *mems)
        fn = lambda m, g: ref_leaf(  # noqa: E731
            rcfg["packed"], m, g, jnp.float32(ETA), COL_AXES)[:2]
        nbytes = {w: ref_leaf_bytes(c, grads[0], COL_AXES)
                  for w, c in rcfg.items()}
    upd, mem = jax.jit(jax.vmap(fn, axis_name="data"))(m, g)
    return ([np.asarray(x) for x in jax.tree.leaves(upd)],
            [np.asarray(x) for x in jax.tree.leaves(mem)], nbytes)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("path,sel", sorted({(p, s) for p, _, s in CASES}))
def test_bf16_sync_matches_reference_at_three_workers(runs, path, sel):
    r_upd, r_mem, r_nbytes = _reference(path, sel)
    dense_below = _cfg(path, "packed", sel).dense_below
    for wire in ("unpacked", "packed"):
        for rank in range(W):
            upd, mem, nbytes = runs[rank][(path, wire, sel)]
            assert nbytes == r_nbytes[wire]
            assert len(upd) == len(r_upd) and len(mem) == len(r_mem)
            for a, b in zip(upd, r_upd):
                a, b = a.numpy(), b[rank]
                if a.size >= dense_below:
                    np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            for a, b in zip(mem, r_mem):
                np.testing.assert_allclose(a.numpy(), b[rank], rtol=0,
                                           atol=1e-6)


@pytest.mark.parametrize("path,sel", sorted({(p, s) for p, _, s in CASES}))
def test_bf16_packed_equals_unpacked_and_ranks_agree(runs, path, sel):
    for rank in range(W):
        p_upd, p_mem, _ = runs[rank][(path, "packed", sel)]
        u_upd, u_mem, _ = runs[rank][(path, "unpacked", sel)]
        for a, b in zip(p_upd + p_mem, u_upd + u_mem):
            assert torch.equal(_bits(a), _bits(b))
    for rank in range(1, W):  # one update on every rank
        for a, b in zip(runs[0][(path, "packed", sel)][0],
                        runs[rank][(path, "packed", sel)][0]):
            assert torch.equal(_bits(a), _bits(b))
