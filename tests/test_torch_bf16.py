"""The port's bf16 arithmetic against the reference's, in process and bit
for bit:

* the densify of gathered bf16 pairs at 3 and 4 workers, in the form each
  selection takes (the reference's ``_pick_selection``: its one-hot einsum,
  a column's float32 sum rounded once, or its scatter, one bf16 add per
  pair), then the mean over the workers against the reference's compiled
  ``densify(...) / n``: a float32 multiply by 1/n, rounded to bf16 for
  the pod mean, left unrounded where ``.astype(float32)`` follows (the
  update);
* the fused Mem-SGD step at bf16 memory (``fused_memsgd_ref``, the plain
  version the CPU runs and the card's kernel is held against) with
  float32 and bf16 g, against the reference's oracle and its
  interpret-mode Pallas kernel: eta rounded to bf16 through float32, g cast
  to bf16, the product and the sum each rounded once to bf16. The etas
  include 0.37 (not exact in bf16) and one within a float32 ulp of a bf16
  midpoint, where rounding float64 to bf16 directly would give the other
  neighbour;
* ``bucket_memory_step`` over bf16 memory buffers.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import buckets as rbk
from repro.core.distributed import SyncConfig as RefSyncConfig
from repro.core.distributed import _pick_selection
from repro.kernels import fused_memsgd_update as ref_fused_update
from repro.kernels.ref import fused_memsgd_ref as ref_fused_ref
from repro_torch.convert import params_from_jax
from repro_torch.core import buckets as bk
from repro_torch.core.distributed import (SyncConfig, _densify_mean,
                                          _densify_onehot, _densify_update,
                                          _pod_mean_select)
from repro_torch.kernels.ref import eta_as, fused_memsgd_ref
from repro_torch.utils.tree import tree_leaves

BF16 = ml_dtypes.bfloat16
# 0.37 is not a bf16; MIDPOINT lies 1e-12 below the midpoint of the bf16
# neighbours 0.369140625 and 0.37109375, and within a float32 ulp of it:
# through float32 it rounds up (ties to even), directly it would round down
MIDPOINT = 0.369140625 + 2**-10 - 1e-12
ETAS = (0.37, MIDPOINT)
# (selection, argmax_k_limit) at k = 6: each of the reference's densify
# forms, argmax_onehot on both sides of its limit
SELECTIONS = [("argmax_onehot", 64), ("argmax_onehot", 4),
              ("threshold_onehot", 64), ("topk_scatter", 64)]


def _torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        b = _torch(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_eta_rounds_through_float32_as_the_reference():
    assert eta_as(MIDPOINT, torch.bfloat16) == 0.37109375
    assert eta_as(MIDPOINT, torch.bfloat16) == float(
        jnp.asarray(MIDPOINT, jnp.bfloat16))
    assert eta_as(0.37, torch.float32) == float(np.float32(0.37))


def _gathered(rows: int, k: int, n: int):
    """n workers' (rows, k) bf16 pairs, tiled in rank order, their columns
    drawn from 24 of 64 so that most columns take several workers' terms."""
    rng = np.random.default_rng(n)
    vals = rng.standard_normal((rows, n * k)).astype(BF16)
    idx = np.concatenate(
        [np.stack([rng.choice(24, k, replace=False) for _ in range(rows)])
         for _ in range(n)], axis=1).astype(np.int32)
    return vals, idx


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("selection,limit", SELECTIONS)
def test_densify_mean_matches_reference(selection, limit, n):
    rows, cols, k = 40, 64, 6
    vals, idx = _gathered(rows, k, n)
    cfg = SyncConfig(selection=selection, argmax_k_limit=limit)
    _, densify = _pick_selection(
        RefSyncConfig(selection=selection, argmax_k_limit=limit,
                      _warn=False), k)
    def mean(v, i):  # the pod mean, bf16
        return densify((rows, cols), v, i, jnp.bfloat16) / n

    def update(v, i):  # the update, cast to float32
        return mean(v, i).astype(jnp.float32)

    args = (jnp.asarray(vals), jnp.asarray(idx))
    wants = (jax.jit(mean)(*args), jax.jit(update)(*args))
    for port, want in zip((_densify_mean, _densify_update), wants):
        got = port(torch.zeros((rows, cols), dtype=torch.bfloat16), 1,
                   _torch(vals), _torch(idx), k, _densify_onehot(cfg, k))
        _assert_bitwise([got], [want])


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("selection,limit", SELECTIONS)
def test_pod_mean_reselect_matches_reference(selection, limit, n):
    """The pod mean's re-select at k_pod = 5 (and the residual, the pod
    mean less its selection) against the reference's ``densify(...) / n``
    and its row top-k compiled together, at worker counts whose 1/n is
    not a power of two. At n = 3 two of the argmax loop's candidates tie
    in bf16 and not in the float32 product its compiled keys keep."""
    rows, cols, k, k_pod = 40, 64, 6, 5
    vals, idx = _gathered(rows, k, n)
    cfg = SyncConfig(selection=selection, argmax_k_limit=limit)
    topk, densify = _pick_selection(
        RefSyncConfig(selection=selection, argmax_k_limit=limit,
                      _warn=False), k)

    def select(v, i):
        return topk(densify((rows, cols), v, i, jnp.bfloat16) / n, k_pod)

    def select_residual(v, i):
        pod_mean = densify((rows, cols), v, i, jnp.bfloat16) / n
        pvals, pidx = topk(pod_mean, k_pod)
        residual = pod_mean - densify((rows, cols), pvals, pidx,
                                      jnp.bfloat16)
        return pvals, pidx, residual

    args = (jnp.asarray(vals), jnp.asarray(idx))
    pod_mean = torch.zeros((rows, cols), dtype=torch.bfloat16)
    pvals, pidx = _pod_mean_select(cfg, pod_mean, _torch(vals), _torch(idx),
                                   k, k_pod)
    residual = pod_mean.scatter_(1, pidx.to(torch.int64), 0.0)
    _assert_bitwise([pvals, pidx], jax.jit(select)(*args))
    _assert_bitwise([pvals, pidx, residual], jax.jit(select_residual)(*args))


@pytest.mark.parametrize("g_dtype", [np.float32, BF16])
@pytest.mark.parametrize("eta", ETAS)
def test_fused_step_at_bf16_memory_matches_reference(eta, g_dtype):
    rng = np.random.default_rng(5)
    m = rng.standard_normal((16, 256)).astype(BF16)
    g = rng.standard_normal((16, 256)).astype(np.float32).astype(g_dtype)
    got = fused_memsgd_ref(_torch(m), _torch(g), eta, 8)
    assert [t.dtype for t in got] == [torch.bfloat16] * 2 + [torch.int32]
    _assert_bitwise(got, ref_fused_ref(jnp.asarray(m), jnp.asarray(g), eta,
                                       8))
    for method in ("loop", "threshold"):
        _assert_bitwise(got, ref_fused_update(
            jnp.asarray(m), jnp.asarray(g), eta, 8, interpret=True,
            method=method))


@pytest.mark.parametrize("eta", ETAS)
def test_bucket_memory_step_at_bf16_memory_matches_reference(eta):
    """A sparse bucket (its fused step in bf16) and a dense one (eta
    rounded to bf16, u float32 as the reference's promotion makes it)."""
    rng = np.random.default_rng(7)
    tree_np = {"w": rng.standard_normal((128, 256)).astype(np.float32),
               "v": rng.standard_normal((300, 70)).astype(np.float32),
               "b": rng.standard_normal((64,)).astype(np.float32)}
    tree = params_from_jax(tree_np)
    plan = bk.make_plan(tree, cols=512)
    rplan = rbk.make_plan({k: jnp.asarray(v) for k, v in tree_np.items()},
                          cols=512)
    assert sorted(s.kind for s in plan.buckets) == ["dense", "sparse"]
    mem_np = [rng.standard_normal(s.shape).astype(BF16)
              for s in plan.buckets]
    k_for = lambda c: max(1, c // 64)  # noqa: E731
    applied, new_mem, _ = bk.bucket_memory_step(
        plan, [_torch(m) for m in mem_np], tree, eta, k_for)
    r_applied, r_mem, _ = rbk.bucket_memory_step(
        rplan, [jnp.asarray(m) for m in mem_np],
        {k: jnp.asarray(v) for k, v in tree_np.items()}, eta, k_for)
    _assert_bitwise(list(new_mem), list(r_mem))
    _assert_bitwise([applied[k] for k in sorted(tree_np)],
                    [r_applied[k] for k in sorted(tree_np)])
    assert len(tree_leaves(applied)) == 3
