"""Minimal optax-style GradientTransformation protocol (port of
``repro.optim.base``).

    state = tx.init(params)
    updates, state = tx.update(grads, state, params=None, **extra)
    params = params + updates                     # leafwise

Updates returned by transformations are ADDITIVE (already negated where a
descent step is intended), exactly like optax.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (updates, state, params=None, **extra)
