"""PARALLEL-MEM-SGD gradient sync (port of ``repro.core.distributed``):
the bucketed path and the per-leaf path.

Each data-parallel worker w:

  1. holds its own error-feedback memory m_w (paper Algorithm 2),
  2. forms u_w = m_w + eta * g_w for its local gradient g_w,
  3. selects ROW-BLOCK top-k (values, indices) per bucket or leaf row,
  4. exchanges only those pairs (all-gather over the workers),
  5. scatters the W*k received pairs into a dense update and divides by W,
  6. keeps m_w' = u_w - own_selection.

``bucketed_sync_gradients`` runs steps 2, 3 and 6 as one fused CUDA
kernel per sparse bucket (``kernels.fused_memsgd_update``): its residual
m' is the reference's ``u - own`` (up to the sign of zero at selected
entries), whatever ``selection`` names. ``sparse_sync_gradients``, the
per-leaf path (the train CLI's default), forms u per leaf, moves the
leaf's column axis last and selects with ``kernels.row_topk``: the
reference's ``selection`` variants exist for XLA's partitioner, and in the
port each maps to a top-k method of one contract (``_row_topk_method``).

What the port runs: one worker (W = 1, where the gather is the
identity), the ``sparse_allgather`` and ``dense`` strategies, the unpacked
wire. Every other option raises ``NotImplementedError`` naming it: the
hierarchical strategy, the packed wire, quantization, local steps > 1,
the overlap schedule and more than one worker.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import buckets as bk
from repro_torch.kernels import fused_memsgd_update, row_topk
from repro_torch.kernels.ref import eta32
from repro_torch.utils.tree import tree_flatten

STRATEGIES = ("sparse_allgather", "hierarchical", "dense")
SELECTIONS = ("topk_scatter", "argmax_onehot", "threshold_onehot")
VALUE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """How gradients are synchronized across the data-parallel workers.

    Flat fields with the reference's names and defaults (the reference
    groups the pod/wire/transport knobs into sub-configs). The reference's
    ``layout`` and ``constrain_intermediates`` serve its partitioner and
    have no counterpart: at one worker with no model axis every layout
    selects over the same rows."""

    strategy: str = "sparse_allgather"  # | "dense" ("hierarchical" not ported)
    ratio: float = 0.001  # per-row k_row = max(k_min, ratio * row_len)
    k_min: int = 1
    k_max: Optional[int] = None
    local_steps: int = 1  # > 1 (Qsparse-local-SGD) not ported
    dense_below: int = 16_384  # smaller leaves sync densely
    # the reference's selection implementations; every one gives the same
    # contract. The bucketed path runs each on the fused kernel; the
    # per-leaf path maps each to a top-k method (_row_topk_method)
    selection: str = "argmax_onehot"
    argmax_k_limit: int = 64  # argmax_onehot takes the threshold above it
    bucketed: bool = False  # False: the per-leaf path
    bucket_cols: int = 1024
    wire: str = "unpacked"  # "packed" not ported
    value_dtype: str = "float32"
    quant: Optional[int] = None  # QSGD levels, not ported
    overlap: Optional[bool] = None  # bucket pipeline schedule, not ported

    def validate(self) -> "SyncConfig":
        """Raise a named error for an unknown value (``ValueError``) or an
        option the port does not run yet (``NotImplementedError``)."""
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown sync strategy {self.strategy!r}")
        if self.selection not in SELECTIONS:
            raise ValueError(
                f"unknown SyncConfig.selection {self.selection!r}")
        if self.wire not in ("unpacked", "packed"):
            raise ValueError(f"unknown wire format {self.wire!r}")
        if self.value_dtype not in VALUE_DTYPES:
            raise ValueError(
                f"unsupported value_dtype {self.value_dtype!r}; options: "
                f"{VALUE_DTYPES}")
        if self.local_steps < 1:
            raise ValueError(
                f"SyncConfig.local_steps must be >= 1, got {self.local_steps}")
        unported = [
            (self.strategy == "hierarchical", "strategy='hierarchical'"),
            (self.wire == "packed", "wire='packed'"),
            (self.quant is not None, "quant (QSGD wire quantization)"),
            (self.local_steps > 1, "local_steps > 1"),
            (self.overlap is not None, "overlap (bucket pipeline)"),
        ]
        for hit, name in unported:
            if hit:
                raise NotImplementedError(
                    f"SyncConfig {name} is not ported to the PyTorch port yet")
        return self

    def k_for(self, row_len: int) -> int:
        k = max(self.k_min, int(round(self.ratio * row_len)))
        if self.k_max is not None:
            k = min(k, self.k_max)
        return min(k, row_len)


def world_size() -> int:
    """Data-parallel workers: the torch.distributed world, else 1."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def _check_single_worker() -> None:
    W = world_size()
    if W != 1:
        raise NotImplementedError(
            f"sync over {W} workers (the torch.distributed gather) is not "
            "ported yet; the port runs one worker")


def _row_topk_method(cfg: SyncConfig, k_row: int) -> str:
    """The ``kernels.row_topk`` method for one leaf (the reference's
    ``_pick_selection``, whose rule it keeps): ``argmax_onehot`` is the
    loop up to ``argmax_k_limit`` and the threshold above it,
    ``threshold_onehot`` the loop up to the device's cutover and the
    threshold above it ("auto"), ``topk_scatter`` the threshold."""
    if cfg.selection == "threshold_onehot":
        return "auto"
    if cfg.selection == "argmax_onehot" and k_row <= cfg.argmax_k_limit:
        return "loop"
    return "threshold"


def _flatten_with(treedef, tree, n: int):
    return [None] * n if tree is None else treedef.flatten_up_to(tree)


def sparse_sync_gradients(cfg: SyncConfig, memory_tree, grad_tree, eta,
                          col_axes=None):
    """PARALLEL-MEM-SGD gradient exchange on a parameter tree, leaf by leaf.

    ``memory_tree``: this worker's float32 memory, one tensor of each
    leaf's shape. ``eta``: a number. ``col_axes``: tree of ints (None: the
    last axis), the axis each leaf selects along
    (``repro_torch.launch.sharding.sync_col_axes``).

    Per leaf: u = m + eta*g (two float32 ops, eta rounded to float32
    once). A leaf below ``dense_below`` entries, or every leaf under
    ``strategy="dense"``, ships all of u. Any other leaf hands the kernel
    its rows with the column axis last, contiguous (a copy when the axis
    was not last, freed once selected), selects k = ``k_for(C)`` pairs per
    row with ``kernels.row_topk``, scatters them back through the moved
    view into a tensor in the parameter's own layout as the update (in
    ``value_dtype``, back to float32), and keeps u - own in place of u as
    its memory.

    Returns (update_tree [float32, SUBTRACT from params], new_memory_tree,
    bytes_per_worker_per_step). Every returned leaf has the layout of its
    memory and gradient leaves (contiguous when they are), whatever its
    column axis, so the memory's layout does not drift from step to step.
    """
    cfg.validate()
    _check_single_worker()
    value_dtype = getattr(torch, cfg.value_dtype)
    eta = eta32(eta)
    leaves_g, treedef = tree_flatten(grad_tree)
    leaves_m = treedef.flatten_up_to(memory_tree)
    leaves_c = _flatten_with(treedef, col_axes, len(leaves_g))
    ups, mems = [], []
    total = 0
    for m, g, c in zip(leaves_m, leaves_g, leaves_c):
        u = torch.add(m, torch.mul(g.to(m.dtype), eta))
        if cfg.strategy == "dense" or u.numel() < cfg.dense_below:
            # mean over one worker is the identity; own = u
            ups.append(u)
            mems.append(u - u)
            total += u.numel() * u.element_size()
            continue
        ca = (c if c is not None else u.dim() - 1) % u.dim()
        moved = u.movedim(ca, -1)
        lead, C = moved.shape[:-1], moved.shape[-1]
        rows = moved.reshape(-1, C).contiguous()
        k_row = cfg.k_for(C)
        vals, idx = row_topk(rows, k_row,
                             method=_row_topk_method(cfg, k_row))
        del rows
        vals = vals.view(*lead, k_row)
        idx = idx.to(torch.int64).view(*lead, k_row)
        own = torch.zeros_like(u)
        own.movedim(ca, -1).scatter_(-1, idx, vals)
        if value_dtype == own.dtype:
            update = own
        else:  # the wire's values, densified in their dtype
            update = torch.zeros_like(u, dtype=value_dtype)
            update.movedim(ca, -1).scatter_(-1, idx, vals.to(value_dtype))
            update = update.to(own.dtype)
        ups.append(update)
        mems.append(u.sub_(own))  # u is this leaf's own: memory = u - own
        total += idx.numel() * (value_dtype.itemsize + 4)
        del u, moved, own, update, vals, idx
    return treedef.unflatten(ups), treedef.unflatten(mems), total


def message_bytes(cfg: SyncConfig, params, col_axes=None) -> int:
    """Per-worker per-step bytes the per-leaf sync puts on the wire for a
    parameter tree (tensors, ``meta`` tensors included): a dense leaf's
    float32 values, a sparse leaf's unpacked (value_dtype values, int32
    indices) pairs, k = ``k_for(C)`` per row of its column axis."""
    cfg.validate()
    itemsize = getattr(torch, cfg.value_dtype).itemsize
    leaves, treedef = tree_flatten(params)
    total = 0
    for p, c in zip(leaves, _flatten_with(treedef, col_axes, len(leaves))):
        d = p.numel()
        if cfg.strategy == "dense" or d < cfg.dense_below:
            total += d * 4
            continue
        ca = (c if c is not None else p.dim() - 1) % max(p.dim(), 1)
        C = p.shape[ca] if p.dim() else 1
        total += (d // max(C, 1)) * cfg.k_for(C) * (itemsize + 4)
    return total


def bucketed_sync_gradients(
    cfg: SyncConfig,
    plan: bk.BucketPlan,
    memory_bufs,
    grad_tree,
    eta,
):
    """PARALLEL-MEM-SGD gradient exchange over flat buckets.

    ``memory_bufs``: this worker's float32 (rows, cols) memory, one per
    bucket. ``eta``: a number.

    Returns (update_tree [float32 views into the update buffers, SUBTRACT
    from params], new_memory_bufs, bytes_per_worker_per_step).
    """
    cfg.validate()
    _check_single_worker()
    value_dtype = getattr(torch, cfg.value_dtype)
    g_bufs = bk.pack(plan, grad_tree, dtype=torch.float32)
    ups, mems = [], []
    for spec, m, g in zip(plan.buckets, memory_bufs, g_bufs):
        if cfg.strategy == "dense" or spec.kind == "dense":
            # mean over one worker is the identity; own = u
            u = torch.add(m, torch.mul(g, eta32(eta)))
            ups.append(u)
            mems.append(u - u)
            continue
        k_row = cfg.k_for(spec.cols)
        new_m, vals, idx = fused_memsgd_update(m, g, eta, k_row)
        # at W = 1 the gathered pairs are this worker's own and their mean
        # over workers is the identity: densify in the wire's value dtype,
        # back to float32
        update = torch.zeros(spec.shape, dtype=value_dtype, device=m.device)
        update.scatter_(1, idx.to(torch.int64), vals.to(value_dtype))
        ups.append(update.to(torch.float32))
        mems.append(new_m)
    return bk.unpack(plan, ups), tuple(mems), bucketed_message_bytes(cfg, plan)


def bucketed_message_bytes(cfg: SyncConfig, plan: bk.BucketPlan) -> int:
    """Per-worker per-step bytes the sync puts on the wire for a plan: the
    dense buckets' float32 buffers, and each sparse bucket's unpacked
    (value_dtype values, int32 indices) pairs."""
    cfg.validate()
    itemsize = getattr(torch, cfg.value_dtype).itemsize
    total = 0
    for spec in plan.buckets:
        if cfg.strategy == "dense" or spec.kind == "dense":
            total += spec.rows * spec.cols * 4
        else:
            total += spec.rows * cfg.k_for(spec.cols) * (itemsize + 4)
    return total
