"""Mem-SGD (Algorithm 1) as a composable GradientTransformation (port of
``repro.core.memsgd``).

The transformation receives RAW gradients and returns the ADDITIVE update
-comp_k(m + eta*g); the stepsize eta is consumed HERE (at memory-insertion
time, per the paper — not applied downstream), so Mem-SGD must be the
final element of an optimizer chain.

Three constructors:

* ``memsgd(compressor, eta_schedule)`` — sequential Algorithm 1 on a
  parameter tree with per-leaf compression.
* ``memsgd_bucketed(...)`` — Algorithm 1 on the bucketed flat-buffer
  engine (``repro_torch.core.buckets``): one fused kernel launch per
  sparse bucket per step.
* ``memsgd_flat(...)`` — operates on a single flat vector (the paper's
  logistic-regression setting, x in R^d).

Schedules are host functions of the integer step count returning a
Python float: the port keeps the count on the host, so reading eta never
waits on the device. The reference's PRNG key in the state is a
``torch.Generator`` owned by the state, on the parameters' device, seeded
from ``seed``; the operators that draw (``rand_k``,
``random_coordinate``) draw from it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import compression as comp_lib
from repro_torch.core.compression import Compressor
from repro_torch.core.memory import init_memory, tree_memory_step
from repro_torch.kernels.ref import eta32
from repro_torch.optim.base import GradientTransformation
from repro_torch.utils.tree import tree_leaves, tree_map

Schedule = Callable[[int], float]


class MemSGDState(NamedTuple):
    count: int  # step t
    memory: object  # a tree like params, or one float32 buffer per bucket
    rng: Optional[torch.Generator] = None


def constant_eta(eta: float) -> Schedule:
    e = eta32(eta)
    return lambda t: e


def _device_of(tree) -> torch.device:
    leaves = tree_leaves(tree)
    if leaves and isinstance(leaves[0], torch.Tensor):
        return leaves[0].device
    return torch.device("cpu")


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def leaf_compressor_from_ratio(ratio: float, block: Optional[int] = None,
                               mode: str = "top_k") -> Callable:
    """Per-leaf compressor: k = max(1, round(ratio*size)).

    ``mode`` in {"top_k", "rand_k", "blockwise"}; blockwise uses
    k_per_block = max(1, round(ratio*block)).
    """

    def for_leaf(g: torch.Tensor) -> Compressor:
        d = g.numel()
        if mode == "blockwise":
            b = block or 1024
            return comp_lib.blockwise_top_k(max(1, int(round(ratio * b))), b)
        k = max(1, min(d, int(round(ratio * d))))
        if mode == "top_k":
            return comp_lib.top_k(k)
        if mode == "rand_k":
            return comp_lib.rand_k(k)
        raise ValueError(mode)

    return for_leaf


def memsgd(
    compressor_for_leaf: Callable[[torch.Tensor], Compressor],
    eta_schedule: Schedule,
    seed: int = 0,
    needs_rng: bool = True,
) -> GradientTransformation:
    """Sequential Mem-SGD over a parameter tree (Algorithm 1). The memory
    and the generator live on the device of the parameters given to
    ``init``."""

    def init(params):
        return MemSGDState(count=0, memory=init_memory(params),
                           rng=_generator(seed, _device_of(params)))

    def update(grads, state: MemSGDState, params=None, **_):
        eta = eta_schedule(state.count)
        applied, new_mem = tree_memory_step(
            compressor_for_leaf, state.memory, grads, eta,
            state.rng if needs_rng else None)
        updates = tree_map(torch.neg, applied)
        return updates, MemSGDState(count=state.count + 1, memory=new_mem,
                                    rng=state.rng)

    return GradientTransformation(init, update)


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
        return MemSGDState(
            count=0,
            memory=bk.init_bucket_memory(plan_of(params),
                                         device=_device_of(params)),
        )

    def update(grads, state: MemSGDState, params=None, **_):
        eta = eta_schedule(state.count)
        applied, new_mem, _ = bk.bucket_memory_step(
            plan_of(grads), state.memory, grads, eta, k_for, method=method
        )
        updates = tree_map(torch.neg, applied)
        return updates, MemSGDState(count=state.count + 1, memory=new_mem)

    return GradientTransformation(init, update)


# ---------------------------------------------------------------------------
# Flat-vector variant (paper's setting: x in R^d)
# ---------------------------------------------------------------------------


class FlatMemSGDState(NamedTuple):
    count: int
    memory: torch.Tensor  # (d,) float32
    rng: torch.Generator


def memsgd_flat(
    compressor: Compressor, eta_schedule: Schedule, d: int, seed: int = 0
) -> GradientTransformation:
    """Mem-SGD on one flat vector x in R^d. ``init(x)`` puts the memory
    and the generator on x's device (the CPU if x is not a tensor)."""

    def init(params):
        device = _device_of(params)
        return FlatMemSGDState(
            count=0, memory=torch.zeros((d,), dtype=torch.float32,
                                        device=device),
            rng=_generator(seed, device))

    def update(grad, state: FlatMemSGDState, params=None, **_):
        eta = eta_schedule(state.count)
        u = state.memory + eta * grad
        applied = compressor.dense(
            u, state.rng if compressor.needs_rng else None)
        new_mem = u - applied
        return -applied, FlatMemSGDState(
            count=state.count + 1, memory=new_mem, rng=state.rng)

    return GradientTransformation(init, update)
