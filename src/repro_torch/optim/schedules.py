"""Learning-rate schedules (port of ``repro.optim.schedules``).

Each schedule is a host function of the integer step count returning a
Python float. The reference traces its schedules in float32, with its
Python scalars cast to float32 where JAX's weak typing casts them; each
schedule here runs the same float32 operations in the same order
(``numpy.float32`` arithmetic rounds each one as XLA does), so the values
are the reference's bit for bit (``warmup_cosine``'s cosine within one
ulp: the two libraries' float32 cosines may differ there).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
f32 = np.float32


def constant(v: float) -> Schedule:
    e = float(f32(v))
    return lambda t: e


def inverse_time(gamma: float, lam: float, a: float) -> Schedule:
    """gamma / (lam * (t + a)) — the paper's schedule family."""
    return lambda t: float(f32(gamma) / (f32(lam) * (f32(t) + f32(a))))


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0) -> Schedule:
    def sched(t: int) -> float:
        tf = f32(t)
        if tf < f32(warmup_steps):
            return float(f32(peak) * tf / f32(max(1, warmup_steps)))
        frac = np.clip((tf - f32(warmup_steps))
                       / f32(max(1, total_steps - warmup_steps)),
                       f32(0.0), f32(1.0))
        cos = f32(1) + np.cos(f32(np.pi) * frac)
        return float(f32(floor) + f32((peak - floor) * 0.5) * cos)

    return sched


def linear_decay(peak: float, total_steps: int) -> Schedule:
    def sched(t: int) -> float:
        frac = np.clip(f32(t) / f32(max(1, total_steps)), f32(0.0), f32(1.0))
        return float(f32(peak) * (f32(1.0) - frac))

    return sched
