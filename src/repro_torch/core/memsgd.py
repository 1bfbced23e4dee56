"""Mem-SGD (Algorithm 1) on the bucketed engine, as a GradientTransformation
(port of ``repro.core.memsgd.memsgd_bucketed``).

The transformation receives RAW gradients and returns the ADDITIVE update
-comp_k(m + eta*g); the stepsize eta is consumed HERE (at memory-insertion
time, per the paper — not applied downstream), so Mem-SGD must be the
final element of an optimizer chain.

Schedules are host functions of the integer step count returning a
Python float: the port keeps the count on the host, so reading eta never
waits on the device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.ref import eta32
from repro_torch.optim.base import GradientTransformation
from repro_torch.utils.tree import tree_leaves, tree_map

Schedule = Callable[[int], float]


class MemSGDState(NamedTuple):
    count: int  # step t
    memory: Tuple[torch.Tensor, ...]  # one float32 buffer per bucket


def constant_eta(eta: float) -> Schedule:
    e = eta32(eta)
    return lambda t: e


def memsgd_bucketed(
    ratio: float,
    eta_schedule: Schedule,
    *,
    cols: Optional[int] = None,
    dense_below: Optional[int] = None,
    k_min: int = 1,
    method: str = "auto",
) -> GradientTransformation:
    """Mem-SGD over dtype-homogeneous flat buckets (one fused launch per
    sparse bucket per step).

    ``ratio`` sets the per-row k = max(k_min, round(ratio * cols)); small
    leaves (< dense_below) ride in a dense bucket, uncompressed. The
    memory lives on the device of the parameters given to ``init``.
    """
    from repro_torch.core import buckets as bk

    cols = bk.DEFAULT_BUCKET_COLS if cols is None else cols
    dense_below = bk.DEFAULT_DENSE_BELOW if dense_below is None else dense_below

    def k_for(c: int) -> int:
        return max(k_min, min(c, int(round(ratio * c))))

    def plan_of(tree) -> "bk.BucketPlan":
        return bk.make_plan(tree, cols=cols, dense_below=dense_below)

    def init(params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        return MemSGDState(
            count=0,
            memory=bk.init_bucket_memory(plan_of(params), device=device),
        )

    def update(grads, state: MemSGDState, params=None, **_):
        eta = eta_schedule(state.count)
        applied, new_mem, _ = bk.bucket_memory_step(
            plan_of(grads), state.memory, grads, eta, k_for, method=method
        )
        updates = tree_map(torch.neg, applied)
        return updates, MemSGDState(count=state.count + 1, memory=new_mem)

    return GradientTransformation(init, update)
