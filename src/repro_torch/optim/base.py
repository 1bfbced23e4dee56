"""Minimal optax-style GradientTransformation protocol (port of
``repro.optim.base``).

    state = tx.init(params)
    updates, state = tx.update(grads, state, params=None, **extra)
    params = apply_updates(params, updates)       # params + updates

Updates returned by transformations are ADDITIVE (already negated where a
descent step is intended), exactly like optax. Trees are nested dicts of
tensors or single tensors (``repro_torch.utils.tree``); step counts are
host integers, and schedules are host functions of the count returning a
Python float rounded to float32 (``repro_torch.optim.schedules``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_map


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (updates, state, params=None, **extra)


def apply_updates(params, updates):
    """params + updates, leafwise, each in its parameter's dtype (new
    tensors: the inputs are left as they are)."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None, **extra):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params=params, **extra)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def identity_tx() -> GradientTransformation:
    return GradientTransformation(lambda p: (), lambda u, s, params=None, **_: (u, s))


class ScaleByScheduleState(NamedTuple):
    count: int


def scale(factor: float) -> GradientTransformation:
    return GradientTransformation(
        lambda p: (),
        lambda u, s, params=None, **_: (tree_map(lambda x: factor * x, u), s),
    )


def times_f32(e: float, x: torch.Tensor) -> torch.Tensor:
    """e * x for a schedule's value e: the reference's schedules return a
    float32 array, which promotes a lower-precision x to float32."""
    return x.to(torch.promote_types(x.dtype, torch.float32)) * e


def scale_by_schedule(schedule: Callable[[int], float]) -> GradientTransformation:
    """Multiply updates by schedule(count); count increments per update."""

    def init(params):
        return ScaleByScheduleState(count=0)

    def update(updates, state, params=None, **_):
        s = schedule(state.count)
        updates = tree_map(lambda x: times_f32(s, x), updates)
        return updates, ScaleByScheduleState(count=state.count + 1)

    return GradientTransformation(init, update)
