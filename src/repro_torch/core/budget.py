"""Cross-pod byte-budget controller for the two-level sync (port of
``repro.core.budget``).

``distributed.autotune_pod_ratios`` sizes each bucket's pod-stage k for a
MASS-CAPTURE target: the smallest k whose top-k holds a fixed fraction of
the mass the pod stage can see. ``BudgetController`` answers that and the
operator's other question, "I can afford N bytes per step across the slow
link: where do they buy the most mass?", from one measurement:

* ``measure`` takes each sparse bucket's ABSOLUTE captured-mass curve on
  the pod-mean proxy (``buckets.simulate_pod_mean`` when per-shard
  buffers are given);
* ``allocate_mass_target`` is the autotuner's sizing
  (``distributed.autotune_pod_ratios`` delegates here);
* ``allocate_bytes`` WATER-FILLS a cross-pod ``byte_budget``: the dense
  buckets' fixed cost and every sparse bucket's mandatory first slot are
  charged first, then slots go one at a time to the bucket whose next
  slot buys the most captured mass per wire byte (the byte cost from
  ``encoding.message_nbytes``, so a slot that fits in a word already paid
  for is free). Top-k capture curves are concave, so the greedy
  allocation is optimal.

Either mode gives per-bucket pod ks clamped to the static padded ceilings
(``SyncConfig.pod_k_max_for_bucket`` / ``k_caps``): the ``pod_ks`` the
k-padded dynamic wire takes, so a refresh changes data, not shapes.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import buckets as bk
from repro_torch.core import encoding as enc


@dataclasses.dataclass(frozen=True)
class BucketCurve:
    """One bucket's measured allocation inputs. ``abs_capture[k-1]``: the
    absolute squared mass (summed over rows) the k largest-|.| entries of
    the pod-mean proxy hold, comparable across buckets; ``rel_capture``:
    the same curve normalized within the visible ``support``. Dense
    buckets carry empty curves and a fixed ``min_nbytes``."""

    bucket: int
    kind: str  # "sparse" | "dense"
    rows: int
    cols: int
    support: int  # pod-mean support bound (n_data * k_row, capped)
    k_cap: int  # static padded ceiling the allocation may not exceed
    abs_capture: np.ndarray  # (k_cap,) absolute captured mass at k
    rel_capture: np.ndarray  # (support,) support-relative capture at k
    min_nbytes: int  # cost of the mandatory allocation (k=1 | dense)


def _abs_capture(buf: torch.Tensor, max_k: int) -> np.ndarray:
    """Absolute captured squared mass, summed over rows, of a (rows, cols)
    buffer for k in 1..max_k (float32): ``bucket_mass_capture``'s
    absolute sibling, which a global budget can compare across buckets."""
    max_k = max(1, min(int(max_k), buf.shape[-1]))
    sq = torch.square(torch.abs(buf.to(torch.float32)))
    desc = torch.topk(sq, max_k, dim=-1).values
    del sq
    return torch.sum(torch.cumsum(desc, dim=-1), dim=0).cpu().numpy()


class BudgetController:
    """Per-bucket pod-k allocator over measured mass/byte curves.

    ``cfg``: a ``SyncConfig``; ``plan``: a ``buckets.BucketPlan``;
    ``n_data``: the intra-pod worker count (the support bound);
    ``k_caps``: the static padded ceilings (the step's ``pod_k_max`` on
    the dynamic path; None leaves only the support bound)."""

    def __init__(self, cfg, plan, n_data: int,
                 k_caps: Optional[Sequence[int]] = None):
        self.cfg = cfg
        self.plan = plan
        self.n_data = int(n_data)
        self.k_caps = None if k_caps is None else tuple(
            int(c) for c in k_caps)

    def _nbytes(self, rows: int, cols: int, k: int) -> int:
        return enc.message_nbytes(rows, cols, k, self.cfg.value_dtype,
                                  self.cfg.wire)

    # -- measurement --------------------------------------------------------

    def measure(self, u_bufs) -> List[BucketCurve]:
        """Per-bucket u = m + eta*g buffers, ``(n_shards, rows, cols)``
        per-shard stacks or ``(rows, cols)`` (a global buffer, or the pod
        mean already formed) -> one ``BucketCurve`` per bucket."""
        curves = []
        for b, (spec, u) in enumerate(zip(self.plan.buckets, u_bufs)):
            if spec.kind == "dense":
                curves.append(BucketCurve(
                    bucket=b, kind="dense", rows=spec.rows, cols=spec.cols,
                    support=spec.cols, k_cap=spec.cols,
                    abs_capture=np.zeros(0), rel_capture=np.zeros(0),
                    min_nbytes=spec.rows * spec.cols * 4))
                continue
            k_row = self.cfg.k_for(spec.cols)
            support = max(1, min(spec.cols, self.n_data * k_row))
            if u.dim() == 3:  # simulate the realized pod mean
                u = bk.simulate_pod_mean(u, k_row)
            k_cap = support
            if self.k_caps is not None:
                k_cap = max(1, min(k_cap, self.k_caps[b]))
            curves.append(BucketCurve(
                bucket=b, kind="sparse", rows=spec.rows, cols=spec.cols,
                support=support, k_cap=k_cap,
                abs_capture=_abs_capture(u, k_cap),
                rel_capture=bk.support_relative_capture(u, support),
                min_nbytes=self._nbytes(spec.rows, spec.cols, 1)))
        return curves

    # -- allocation ---------------------------------------------------------

    def allocate_mass_target(self, curves: Sequence[BucketCurve],
                             mass_target: Optional[float] = None
                             ) -> Tuple[int, ...]:
        """Per sparse bucket the smallest k whose support-relative capture
        reaches the target, clamped to [k_min, support], then to the
        static ceiling. Dense buckets get k = 1 (never consulted)."""
        target = (self.cfg.pod_mass_target
                  if mass_target is None else mass_target)
        ks = []
        for c in curves:
            if c.kind == "dense":
                ks.append(1)
                continue
            k = int(np.searchsorted(c.rel_capture, target, side="left")) + 1
            k = max(self.cfg.k_min, min(k, c.support))
            if self.k_caps is not None:
                k = max(1, min(k, self.k_caps[c.bucket]))
            ks.append(k)
        return tuple(ks)

    def allocate_bytes(self, curves: Sequence[BucketCurve],
                       byte_budget: int) -> Tuple[int, ...]:
        """Water-fill ``byte_budget`` cross-pod bytes/step/worker over the
        buckets: charge the fixed costs (dense buckets, each sparse
        bucket's k = 1 slot), then grant the slot of highest marginal
        mass per marginal byte, one at a time (a zero-cost slot first). An
        infeasible budget leaves every sparse bucket at k = 1, the least
        the codec ships."""
        ks = {c.bucket: 1 for c in curves}
        remaining = int(byte_budget) - sum(c.min_nbytes for c in curves)
        # (-density, bucket, cost, gain) of each bucket's NEXT slot
        heap = []

        def push(c):
            k = ks[c.bucket]
            if k >= c.k_cap:
                return
            gain = float(c.abs_capture[k] - c.abs_capture[k - 1])
            cost = (self._nbytes(c.rows, c.cols, k + 1)
                    - self._nbytes(c.rows, c.cols, k))
            dens = np.inf if cost == 0 else gain / cost
            heapq.heappush(heap, (-dens, c.bucket, cost, gain))

        sparse = {c.bucket: c for c in curves if c.kind == "sparse"}
        for c in sparse.values():
            push(c)
        while heap and remaining >= 0:
            neg_dens, b, cost, _ = heapq.heappop(heap)
            if cost > remaining or neg_dens == 0.0:
                # this slot does not fit or buys nothing: retire the
                # bucket (its later slots cost more and capture less)
                continue
            ks[b] += 1
            remaining -= cost
            push(sparse[b])
        return tuple(ks[c.bucket] for c in curves)

    def allocate(self, u_bufs, byte_budget: Optional[int] = None,
                 mass_target: Optional[float] = None) -> Tuple[int, ...]:
        """Measure and allocate: the byte budget (the argument, else
        ``cfg.byte_budget``) when one is set, else the mass target."""
        curves = self.measure(u_bufs)
        budget = (byte_budget if byte_budget is not None
                  else self.cfg.byte_budget)
        if budget is not None:
            return self.allocate_bytes(curves, budget)
        return self.allocate_mass_target(curves, mass_target)

    # -- emission -----------------------------------------------------------

    def ratios_of(self, ks: Sequence[int]) -> Tuple[float, ...]:
        """Per-bucket ks -> ``SyncConfig.pod_ratios`` (dense 1.0, sparse
        k / cols, which ``int(round(r * cols))`` turns back into k)."""
        return tuple(1.0 if spec.kind == "dense" else k / spec.cols
                     for spec, k in zip(self.plan.buckets, ks))

    def cross_bytes_of(self, ks: Sequence[int]) -> int:
        """Cross-pod bytes/step/worker of an allocation, as the repack
        transport ships them (dense buckets whole, sparse at
        ``message_nbytes(k)``)."""
        total = 0
        for spec, k in zip(self.plan.buckets, ks):
            if spec.kind == "dense":
                total += spec.rows * spec.cols * 4
            else:
                total += self._nbytes(spec.rows, spec.cols,
                                      max(1, min(int(k), spec.cols)))
        return total
