"""Adam / AdamW (Kingma & Ba '14; port of ``repro.optim.adam``), used by
the large-model training driver's ``adam_compressed`` mode.

The moments are float32 trees; the bias corrections 1 - b^t are host
floats computed in float32, as the reference computes them."""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import numpy as np
import torch

from repro_torch.optim.base import GradientTransformation
from repro_torch.optim.sgd import as_schedule
from repro_torch.utils.tree import tree_map

Schedule = Callable[[int], float]


class AdamState(NamedTuple):
    count: int
    mu: object
    nu: object


def bias_correction(b: float, t: int) -> float:
    """1 - b ** t in float32."""
    return float(np.float32(1) - np.float32(b) ** np.float32(t))


def adam(
    eta: Union[Schedule, float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> GradientTransformation:
    sched = as_schedule(eta)

    def init(params):
        def zeros():
            return tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)

        return AdamState(count=0, mu=zeros(), nu=zeros())

    def update(grads, state: AdamState, params=None, **_):
        t = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, grads)
        nu = tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
            state.nu, grads)
        bc1, bc2 = bias_correction(b1, t), bias_correction(b2, t)
        e = sched(state.count)

        def leaf(m, v, p):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and params is not None:
                step = step + weight_decay * p.to(torch.float32)
            return (-e * step).to(p.dtype)

        if params is not None:
            updates = tree_map(leaf, mu, nu, params)
        else:
            updates = tree_map(lambda m, v: leaf(m, v, m), mu, nu)
        return updates, AdamState(count=t, mu=mu, nu=nu)

    return GradientTransformation(init, update)
