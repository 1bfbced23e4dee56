"""Trainer -> serving-replica parameter deltas over the packed wire (port
of ``repro.launch.delta_stream``).

A serving replica only needs the per-step change of the parameters, and
under Mem-SGD that change IS the sparse bucket message: the applied
update is the densified mean of the workers' top-k selections, so its
support per (rows, cols) bucket row is at most ``W * k_row`` entries
(``n_pods * k_pod`` for the two-level sync). Re-selecting the top-k' of
the update buffer with k' = that support bound therefore captures EVERY
nonzero, and streaming it through ``core.encoding`` costs
``k' * (value_bits + ceil(log2 cols))`` bits a row instead of a dense
parameter broadcast.

Exactness: the replica subtracts the bit-identical float32 ``u`` the
trainer subtracted, ``p - u.to(p.dtype)`` (the port's apply step, in
place), so its params track the trainer's bit for bit step by step.
Dense buckets (norm scales, biases) stream uncompressed as a
``kind="dense"`` message. With ``value_dtype="bfloat16"`` the stream is
lossy (rounded values) and about half the size.

The re-select is ``kernels.ops.row_topk`` (the row top-k kernels on the
card: decreasing |v|, ties to the lowest index, the reference's
``jax.lax.top_k``); the decode scatters each row's pairs into a zero
float32 buffer (the reference's ``_row_scatter``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from repro_torch.core import buckets as bk
from repro_torch.core import encoding as enc
from repro_torch.core.distributed import SyncConfig, validate_pod_ratios
from repro_torch.kernels import row_topk


@dataclasses.dataclass(frozen=True)
class DeltaSpec:
    """Static wire layout of one trainer -> replica delta message: one
    ``WireSpec`` per bucket of the training ``BucketPlan``."""

    plan: bk.BucketPlan
    wires: Tuple[enc.WireSpec, ...]

    @property
    def nbytes(self) -> int:
        """Exact bytes per streamed step."""
        return sum(w.nbytes for w in self.wires)

    @property
    def dense_nbytes(self) -> int:
        """Bytes a dense float32 parameter broadcast would cost."""
        return sum(s.rows * s.cols * 4 for s in self.plan.buckets)

    def with_value_dtype(self, value_dtype: str) -> "DeltaSpec":
        """The same per-bucket layout in another wire value dtype (the
        spec of a ``transcode_delta``'d message set)."""
        return DeltaSpec(plan=self.plan, wires=tuple(
            w.with_value_dtype(value_dtype) for w in self.wires))


def make_delta_spec(plan: bk.BucketPlan, cfg: SyncConfig, workers: int,
                    n_pods: int = 1, value_dtype: str = "float32"
                    ) -> DeltaSpec:
    """The per-bucket wire layout from the training sync config.

    ``workers`` / ``n_pods`` bound the update's support a row (see the
    module docstring); ``value_dtype="float32"`` keeps the stream exact.
    With ``cfg.pod_dynamic`` the two-level support bound follows the
    bucket's static ``pod_k_max_for_bucket``, not the live k, so that a
    refresh that raises k never exceeds the encoded support."""
    validate_pod_ratios(cfg, plan)
    wires: List[enc.WireSpec] = []
    for b, spec in enumerate(plan.buckets):
        if cfg.strategy == "dense" or spec.kind == "dense":
            wires.append(enc.WireSpec(spec.rows, spec.cols, spec.cols,
                                      value_dtype, kind="dense"))
            continue
        if cfg.strategy == "hierarchical" and cfg.pod_axis is not None:
            if cfg.pod_dynamic:
                n_data = max(1, workers // max(n_pods, 1))
                support = n_pods * cfg.pod_k_max_for_bucket(b, spec.cols,
                                                            n_data)
            else:
                support = n_pods * cfg.pod_k_for_bucket(b, spec.cols)
        else:
            support = workers * cfg.k_for(spec.cols)
        wires.append(enc.WireSpec(spec.rows, spec.cols,
                                  min(spec.cols, support), value_dtype))
    return DeltaSpec(plan=plan, wires=tuple(wires))


def encode_delta_bufs(dspec: DeltaSpec, bufs: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """Bucket-space update buffers (``bucketed_sync_gradients(...,
    return_bufs=True)``) -> one uint32 wire buffer per bucket, on the
    buffers' device. A sparse bucket re-selects its row top-k' (every
    nonzero, since k' bounds the support; spare slots carry zeros, which
    scatter as no-ops)."""
    out = []
    for wspec, buf in zip(dspec.wires, bufs):
        buf = buf.to(torch.float32)
        if wspec.kind == "dense":
            out.append(enc.encode(wspec, buf))
        else:
            out.append(enc.encode(wspec, *row_topk(buf, wspec.k)))
    return out


def encode_delta(dspec: DeltaSpec, update_tree) -> List[torch.Tensor]:
    """Update tree (what the trainer subtracts from params) -> wire
    buffers: packs it into bucket space first; prefer
    ``encode_delta_bufs`` when the bucket buffers exist."""
    return encode_delta_bufs(
        dspec, bk.pack(dspec.plan, update_tree, dtype=torch.float32))


def _decode_buf(wspec: enc.WireSpec, msg: torch.Tensor) -> torch.Tensor:
    """One wire buffer -> its dense float32 (rows, cols) update."""
    vals, idx = enc.decode(wspec, msg)
    if wspec.kind == "dense":
        return vals.to(torch.float32, copy=True)
    out = torch.zeros((wspec.rows, wspec.cols), dtype=torch.float32,
                      device=vals.device)
    return out.scatter_add_(1, idx.to(torch.int64), vals.to(torch.float32))


def decode_delta(dspec: DeltaSpec, msgs: Sequence[torch.Tensor]):
    """Wire buffers -> dense float32 update tree (exact on the support):
    views into one new (rows, cols) buffer per bucket."""
    return bk.unpack(dspec.plan, [_decode_buf(w, m)
                                  for w, m in zip(dspec.wires, msgs)])


def transcode_delta(dspec: DeltaSpec, msgs: Sequence[torch.Tensor],
                    value_dtype: str = "bfloat16") -> List[torch.Tensor]:
    """Re-encode one step's wire buffers in another value dtype
    (``encoding.transcode``): float32 -> bf16 halves the value sections,
    at the cost of rounded (not bitwise) replica tracking. The result
    decodes against ``dspec.with_value_dtype(value_dtype)``."""
    return [enc.transcode(w, m, value_dtype)
            for w, m in zip(dspec.wires, msgs)]


def apply_delta(params, dspec: DeltaSpec, msgs: Sequence[torch.Tensor]):
    """One replica refresh: ``p -= u.to(p.dtype)`` leaf by leaf, IN PLACE,
    with ``u`` the decoded update, and returns ``params``: the trainer's
    own subtraction (``launch.train``'s apply step is ``p.sub_(u.to(
    p.dtype))``), so a float32 stream keeps the replica's params bit for
    bit the trainer's. The reference returns a new tree; in the port a
    replica owns its buffers (``launch.serve.replica_copy``), so nothing
    else sees the change. Decodes one bucket at a time."""
    leaves = dspec.plan.treedef.flatten_up_to(params)
    for b, (wspec, msg) in enumerate(zip(dspec.wires, msgs)):
        flat = _decode_buf(wspec, msg.to(leaves[0].device)).reshape(-1)
        for p, pl in zip(leaves, dspec.plan.placements):
            if pl.bucket == b:
                u = flat[pl.offset:pl.offset + pl.size].view(pl.shape)
                p.sub_(u.to(p.dtype))
        del flat
    return params
