"""SGD and momentum transformations (descent direction, additive updates;
port of ``repro.optim.sgd``)."""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch.optim.base import GradientTransformation, times_f32
from repro_torch.optim.schedules import constant
from repro_torch.utils.tree import tree_leaves, tree_map

Schedule = Callable[[int], float]


def as_schedule(eta: Union[Schedule, float]) -> Schedule:
    """A schedule, or a number as a constant float32 schedule."""
    return eta if callable(eta) else constant(eta)


class SGDState(NamedTuple):
    count: int


def sgd(eta: Union[Schedule, float]) -> GradientTransformation:
    """x' = x - eta_t * g."""
    sched = as_schedule(eta)

    def init(params):
        return SGDState(count=0)

    def update(grads, state: SGDState, params=None, **_):
        e = sched(state.count)
        return (tree_map(lambda g: times_f32(-e, g), grads),
                SGDState(count=state.count + 1))

    return GradientTransformation(init, update)


class MomentumState(NamedTuple):
    count: int
    velocity: object


def sgd_momentum(
    eta: Union[Schedule, float], beta: float = 0.9, nesterov: bool = False
) -> GradientTransformation:
    sched = as_schedule(eta)

    def init(params):
        return MomentumState(count=0, velocity=tree_map(torch.zeros_like,
                                                        params))

    def update(grads, state: MomentumState, params=None, **_):
        v = tree_map(lambda vel, g: beta * vel + g, state.velocity, grads)
        if nesterov:
            d = tree_map(lambda vel, g: beta * vel + g, v, grads)
        else:
            d = v
        e = sched(state.count)
        return (tree_map(lambda x: times_f32(-e, x), d),
                MomentumState(count=state.count + 1, velocity=v))

    return GradientTransformation(init, update)


def add_weight_decay(lam: float) -> GradientTransformation:
    """g <- g + lam * params (L2 regularization as in the paper's logreg)."""

    def update(grads, state, params=None, **_):
        if params is None:
            raise ValueError("weight decay needs params")
        return tree_map(lambda g, p: g + lam * p, grads, params), state

    return GradientTransformation(lambda p: (), update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every gradient by min(1, max_norm / (||g||_2 + 1e-12)), the
    norm over all leaves in float32 (a device scalar: nothing waits)."""

    def update(grads, state, params=None, **_):
        leaves = tree_leaves(grads)
        gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                            for g in leaves))
        factor = torch.clamp(max_norm / (gn + 1e-12), max=1.0)
        return tree_map(lambda g: g * factor, grads), state

    return GradientTransformation(lambda p: (), update)
