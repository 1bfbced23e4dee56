"""PARALLEL-MEM-SGD gradient sync over buckets (port of the bucketed path
of ``repro.core.distributed``).

Each data-parallel worker w:

  1. holds its own error-feedback memory m_w (paper Algorithm 2),
  2. forms u_w = m_w + eta * g_w for its local gradient g_w,
  3. selects ROW-BLOCK top-k (values, indices) per bucket row,
  4. exchanges only those pairs (all-gather over the workers),
  5. scatters the W*k received pairs into a dense update and divides by W,
  6. keeps m_w' = u_w - own_selection.

Steps 2, 3 and 6 are one fused CUDA kernel per sparse bucket
(``kernels.fused_memsgd_update``): its residual m' is the reference's
``u - own`` (up to the sign of zero at selected entries), whatever
``selection`` names — the reference's selection variants exist for XLA's
partitioner, and every one of them gives the same contract.

What this slice runs: one worker (W = 1, where the gather is the
identity), the ``sparse_allgather`` and ``dense`` strategies, the unpacked
wire. Every other option raises ``NotImplementedError`` naming it: the
hierarchical strategy, the packed wire, quantization, local steps > 1,
the overlap schedule, more than one worker, and the per-leaf
(non-bucketed) path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import buckets as bk
from repro_torch.kernels import fused_memsgd_update
from repro_torch.kernels.ref import eta32

STRATEGIES = ("sparse_allgather", "hierarchical", "dense")
SELECTIONS = ("topk_scatter", "argmax_onehot", "threshold_onehot")
VALUE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """How gradients are synchronized across the data-parallel workers.

    Flat fields with the reference's names and defaults (the reference
    groups the pod/wire/transport knobs into sub-configs)."""

    strategy: str = "sparse_allgather"  # | "dense" ("hierarchical" not ported)
    ratio: float = 0.001  # per-row k_row = max(k_min, ratio * row_len)
    k_min: int = 1
    k_max: Optional[int] = None
    local_steps: int = 1  # > 1 (Qsparse-local-SGD) not ported
    dense_below: int = 16_384  # smaller leaves sync densely
    # the reference's selection implementations; in the port every one
    # runs on the fused kernel (identical contract)
    selection: str = "argmax_onehot"
    bucketed: bool = False  # the per-leaf path (False) is not ported
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
            (not self.bucketed,
             "bucketed=False (the per-leaf sync path; pass bucketed=True)"),
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
            f"bucketed sync over {W} workers (the torch.distributed gather) "
            "is not ported yet; the port runs one worker")


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
