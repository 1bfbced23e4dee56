"""Bucketed flat-buffer engine: tree of tensors -> a handful of 2D buffers.

Port of ``repro.core.buckets``. The gradient tree is packed into a few
large, dtype-homogeneous buffers:

* one SPARSE bucket per gradient dtype: every leaf with
  ``size >= dense_below``, concatenated flat and viewed as (rows, cols).
  Per-row top-k over the bucket is ``blockwise_top_k(k, cols)`` over the
  concatenated parameter vector — a k-contraction with k/d = k/cols, so
  the paper's Theorem 2.4 applies unchanged.
* one DENSE bucket per dtype holding the ``dense_below`` leaves (norm
  scales, biases): synced uncompressed, shaped (1, total).

The error-feedback memory lives in bucket space (one float32 buffer per
bucket), so each step runs one fused kernel launch per sparse bucket
whatever the leaf count.

Padding tail entries are zero in every gradient and start at zero memory,
so they stay zero in u = m + eta*g: ties break to the LOWEST index and
padding sits at the highest indices of the last row, so a padding entry
is selected only into an all-zero tail, contributes nothing, and is
sliced off by ``unpack``.

``bucket_mass_capture``, ``simulate_pod_mean`` and
``support_relative_capture`` measure what a bucket's top-k captures: the
two-level sync's pod-k calibration reads them (``core.budget``).

Leaves are visited in JAX's flatten order (dict keys sorted), so a plan
built here equals the reference's plan for the same shapes: the same
bucket order, placements, rows and cols.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import densify_rows_ref, fused_memsgd_update
from repro_torch.kernels.ref import eta32, eta_as
from repro_torch.utils.tree import TreeDef, tree_flatten

DEFAULT_BUCKET_COLS = 1024
DEFAULT_DENSE_BELOW = 16_384


def dtype_name(dtype: torch.dtype) -> str:
    """Canonical dtype name as the reference writes it ("float32", ...)."""
    return str(dtype).removeprefix("torch.")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static description of one packed buffer."""

    dtype: str  # canonical dtype name, e.g. "float32"
    kind: str  # "sparse" (row-block compressed) | "dense" (uncompressed)
    rows: int
    cols: int
    size: int  # sum of member leaf sizes (<= rows * cols)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)


@dataclasses.dataclass(frozen=True)
class LeafPlacement:
    bucket: int  # index into BucketPlan.buckets
    offset: int  # flat offset within the bucket's (rows*cols,) space
    shape: Tuple[int, ...]
    dtype: str
    size: int


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    treedef: TreeDef
    placements: Tuple[LeafPlacement, ...]
    buckets: Tuple[BucketSpec, ...]

    @property
    def n_dispatch(self) -> int:
        """Compressor/sync dispatches per step (one per bucket)."""
        return len(self.buckets)


def make_plan(
    tree,
    *,
    cols: int = DEFAULT_BUCKET_COLS,
    dense_below: int = DEFAULT_DENSE_BELOW,
) -> BucketPlan:
    """Assign every leaf of ``tree`` (tensors, e.g. on the ``meta``
    device) to a bucket. Grouping key: (dtype, dense|sparse); leaves keep
    their flatten order within a bucket, and buckets are numbered in the
    order their first leaf appears."""
    leaves, treedef = tree_flatten(tree)
    groups: dict = {}  # key -> [leaf indices], in first-seen order
    infos = []
    for i, leaf in enumerate(leaves):
        shape = tuple(leaf.shape)
        size = 1
        for s in shape:
            size *= s
        kind = "dense" if size < dense_below else "sparse"
        dt = dtype_name(leaf.dtype)
        infos.append((shape, dt, size))
        groups.setdefault((dt, kind), []).append(i)

    buckets: List[BucketSpec] = []
    placements: List[Optional[LeafPlacement]] = [None] * len(leaves)
    for b, ((dt, kind), members) in enumerate(groups.items()):
        offset = 0
        for i in members:
            shape, ldt, size = infos[i]
            placements[i] = LeafPlacement(
                bucket=b, offset=offset, shape=shape, dtype=ldt, size=size)
            offset += size
        if kind == "sparse":
            buckets.append(BucketSpec(dt, kind, -(-offset // cols), cols,
                                      offset))
        else:
            buckets.append(BucketSpec(dt, kind, 1, offset, offset))
    return BucketPlan(treedef=treedef, placements=tuple(placements),
                      buckets=tuple(buckets))


def pack(plan: BucketPlan, tree, dtype: Optional[torch.dtype] = None
         ) -> List[torch.Tensor]:
    """Tree -> one (rows, cols) buffer per bucket, zero-padded tail.

    ``dtype`` overrides the per-bucket dtype (e.g. float32 for memory
    math). Each buffer is allocated once and filled leaf by leaf, so
    packing costs one copy of the tree."""
    leaves = plan.treedef.flatten_up_to(tree)
    device = leaves[0].device if leaves else torch.device("cpu")
    out = [
        torch.empty(spec.rows * spec.cols,
                    dtype=dtype if dtype is not None else _dtype(spec.dtype),
                    device=device)
        for spec in plan.buckets
    ]
    for leaf, pl in zip(leaves, plan.placements):
        out[pl.bucket][pl.offset:pl.offset + pl.size].copy_(leaf.reshape(-1))
    for spec, flat in zip(plan.buckets, out):
        flat[spec.size:].zero_()
    return [flat.view(spec.rows, spec.cols)
            for spec, flat in zip(plan.buckets, out)]


def unpack(plan: BucketPlan, buffers: Sequence[torch.Tensor],
           cast: bool = False):
    """Buffers -> tree of leaf-shaped tensors: VIEWS into the buffers
    (buffer dtype), or copies in the original leaf dtype when ``cast``."""
    flats = [b.reshape(-1) for b in buffers]
    leaves = []
    for pl in plan.placements:
        piece = flats[pl.bucket][pl.offset:pl.offset + pl.size].view(pl.shape)
        if cast:
            piece = piece.to(_dtype(pl.dtype))
        leaves.append(piece)
    return plan.treedef.unflatten(leaves)


def bucket_mass_capture(buf: torch.Tensor, max_k: int) -> torch.Tensor:
    """Mean per-row captured squared-mass fraction of a (rows, cols)
    buffer for every k in 1..max_k: ``out[k-1]`` is the fraction of each
    row's squared mass that its k largest-|.| entries hold, averaged over
    rows (an all-zero row counts as fully captured). The curve needs only
    the max_k largest squares of a row, in decreasing order:
    ``torch.topk`` gives that prefix of the reference's full-row sort."""
    max_k = max(1, min(int(max_k), buf.shape[-1]))
    sq = torch.square(torch.abs(buf.to(torch.float32)))
    captured = torch.cumsum(torch.topk(sq, max_k, dim=-1).values, dim=-1)
    total = torch.sum(sq, dim=-1, keepdim=True)
    del sq
    frac = torch.where(total > 0, captured / torch.clamp(total, min=1e-30),
                       1.0)
    return torch.mean(frac, dim=0)


def simulate_pod_mean(u: torch.Tensor, k_row: int) -> torch.Tensor:
    """(n_shards, rows, cols) per-shard bucket buffers -> the intra-pod
    mean the pod-stage selection sees: each shard's per-row top-``k_row``
    (``kernels.row_topk``: decreasing |.|, ties to the lowest index, the
    contract of the reference's ``jax.lax.top_k``), densified, summed
    shard by shard, / n_shards. Overlapping shard selections (correlated
    gradients) concentrate the mass, which is why the autotuner measures
    capture on this proxy."""
    from repro_torch.kernels import row_topk

    n, rows, cols = u.shape
    out = torch.zeros((rows, cols), dtype=torch.float32, device=u.device)
    for shard in u:
        vals, idx = row_topk(shard.to(torch.float32).contiguous(), k_row)
        # a shard's indices are distinct within a row: one add each
        out.scatter_add_(1, idx.to(torch.int64), vals)
    return out.div_(n)


def support_relative_capture(buf: torch.Tensor, support: int) -> np.ndarray:
    """Mean per-row capture curve of a (rows, cols) buffer NORMALIZED
    within the visible ``support`` (numpy, length ``support``): ``out[k-1]``
    is the fraction of the mass the pod stage can see at all that the k
    largest-|.| entries hold."""
    frac = bucket_mass_capture(buf, support).cpu().numpy()
    return frac / max(float(frac[-1]), 1e-30)


def init_bucket_memory(plan: BucketPlan, dtype=torch.float32,
                       device="cpu") -> Tuple[torch.Tensor, ...]:
    """Zero error-feedback memory, one buffer per bucket (m_0 = 0)."""
    return tuple(torch.zeros(spec.shape, dtype=dtype, device=device)
                 for spec in plan.buckets)


def init_local_accum(plan: BucketPlan, dtype=torch.float32,
                     device="cpu") -> Tuple[torch.Tensor, ...]:
    """Zero local-step accumulator, one buffer per bucket.

    Qsparse-local-SGD (``SyncConfig(local_steps=H)``): between syncs each
    worker folds its scaled gradients into this bucket-space accumulator,
    acc = sum_h eta_h * g_h; the sync round then compresses u = m + acc
    and resets acc to zero. The memory's shapes and dtype."""
    return tuple(torch.zeros(spec.shape, dtype=dtype, device=device)
                 for spec in plan.buckets)


def accumulate_local(plan: BucketPlan, acc_bufs: Sequence[torch.Tensor],
                     grad_tree, eta) -> Tuple[torch.Tensor, ...]:
    """One uncommunicated local step: acc + e * pack(g) per bucket, with e
    the float32 eta, as two rounded ops (the product, then the sum), in
    place on ``acc_bufs``, which it returns. ``add_(g, alpha=e)``,
    ``addcmul`` or a compiled fusion could contract the two into one FMA
    on the card, and the accumulator path at H = 1 would no longer give
    the direct path's u = m + e*g (the fused kernel's ``__fmul_rn`` then
    ``__fadd_rn``) bit for bit."""
    g_bufs = pack(plan, grad_tree, dtype=torch.float32)
    e = eta32(eta)
    for a, g in zip(acc_bufs, g_bufs):
        a.add_(torch.mul(g, e))
    return tuple(acc_bufs)


def bucket_memory_step(
    plan: BucketPlan,
    memory_bufs: Sequence[torch.Tensor],
    grad_tree,
    eta,
    k_for: Callable[[int], int],
    *,
    method: str = "auto",
):
    """One Mem-SGD error-feedback step over the buckets.

    For each sparse bucket runs the fused update (u = m + eta*g -> per-row
    top-k -> residual memory) in a single launch; dense buckets pass
    through uncompressed with zero residual.

    Returns (applied_tree [dense comp_k(u), float32 leaves],
    new_memory_bufs, n_dispatch).
    """
    g_bufs = pack(plan, grad_tree, dtype=torch.float32)
    applied_bufs, new_mem = [], []
    for spec, m, g in zip(plan.buckets, memory_bufs, g_bufs):
        if spec.kind == "dense":
            # the reference's m + jnp.asarray(eta, m.dtype) * g: eta in m's
            # dtype, the float32 g promotes u to float32
            u = torch.add(m, torch.mul(g, eta_as(eta, m.dtype)))
            applied_bufs.append(u)
            new_mem.append(torch.zeros_like(u))
            continue
        nm, vals, idx = fused_memsgd_update(m, g, eta, k_for(spec.cols),
                                            method=method)
        applied_bufs.append(densify_rows_ref(m, vals, idx))
        new_mem.append(nm)
    return unpack(plan, applied_bufs), tuple(new_mem), plan.n_dispatch
