"""Theorem 2.4 machinery: stepsizes, shifts, weighted averaging, bounds
(port of ``repro.core.theory``).

Paper's experimental stepsize (Table 2):   eta_t = gamma / (lambda * (t + a))
Theorem stepsize:                          eta_t = 8 / (mu * (a + t))
Shift recommendation (Remark 2.5/2.6):     a = (alpha + 2) * d / k, alpha = 5;
                                           in practice a = d/k suffices.
Averaging (Thm 2.4): x_bar = (1/S_T) * sum_t w_t x_t with w_t = (a + t)^2.

The stepsizes are host functions of the integer step count returning a
Python float, rounded in float32 in the reference's evaluation order (see
``repro_torch.optim.schedules``). The bounds and shifts are plain Python
math, the reference's own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_map

f32 = np.float32


def qsgd_variance_bound(d: int, s: int) -> float:
    """QSGD Lemma 3.1 (Alistarh et al.): the s-level stochastic quantizer
    is unbiased with relative variance
    E||Q_s(x) - x||^2 <= beta ||x||^2, beta = min(d/s^2, sqrt(d)/s)."""
    return min(d / float(s) ** 2, math.sqrt(d) / s)


def composed_contraction(d: int, k: float,
                         s: Optional[int] = None) -> float:
    """Contraction factor delta of the composed compressor
    ``Q_s ∘ top_k`` (Qsparse-local-SGD, Basu et al.):
    E||C(x) - x||^2 <= (1 - delta) ||x||^2, with
    delta = (k/d) * (1 - beta_k), beta_k = min(k/s^2, sqrt(k)/s).
    ``s=None`` (no quantization) reduces to the paper's k/d."""
    base = k / float(d)
    if s is None:
        return base
    beta_k = qsgd_variance_bound(max(1, int(math.ceil(k))), s)
    return base * max(0.0, 1.0 - beta_k)


def local_steps_residual_factor(H: int) -> float:
    """Scale of Thm 2.4's memory-residual term when syncing every H
    steps: the H-step accumulation grows the bound on ||memory||^2 by
    H^2 (Qsparse-local-SGD's H-dependence)."""
    if H < 1:
        raise ValueError(f"local_steps must be >= 1, got {H}")
    return float(H) ** 2


def theoretical_shift(d: int, k: float, alpha: float = 5.0) -> float:
    """a = (alpha+2) d/k — sufficient per Remark 2.5."""
    return (alpha + 2.0) * d / k


def practical_shift(d: int, k: float, factor: float = 1.0) -> float:
    """a = factor * d/k — the paper uses d/k (epsilon) and 10 d/k (RCV1)."""
    return factor * d / k


def paper_stepsize(gamma: float, lam: float, a: float) -> Callable[[int], float]:
    """eta_t = gamma / (lambda (t + a)) — paper Table 2."""
    return lambda t: float(f32(gamma) / (f32(lam) * (f32(t) + f32(a))))


def theorem_stepsize(mu: float, a: float) -> Callable[[int], float]:
    """eta_t = 8 / (mu (a + t)) — Theorem 2.4."""
    return lambda t: float(f32(8.0) / (f32(mu) * (f32(a) + f32(t))))


def bottou_stepsize(gamma0: float, lam: float) -> Callable[[int], float]:
    """eta_t = gamma0 / (1 + gamma0 * lambda * t) — used for the QSGD
    comparison (paper §4.3, Bottou '12). ``gamma0 * lambda`` is a Python
    (float64) product, as in the reference, before its float32 product
    with t."""
    return lambda t: float(
        f32(gamma0) / (f32(1.0) + f32(gamma0 * lam) * f32(t)))


# ---------------------------------------------------------------------------
# Quadratically-weighted running average of iterates (w_t = (a+t)^2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WeightedAverage:
    """Streaming x_bar_T = sum w_t x_t / S_T without storing the iterates.

    Maintains (running weighted sum, running weight) on trees of tensors:
    the sum is float32 tensors on the iterates' device, the weight a
    host float accumulated in float32, as the reference accumulates it
    (the weights reach ~1e11 at the paper's scale)."""

    a: float

    def init(self, params):
        return (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params), 0.0)

    def update(self, avg_state, params, t: int):
        wsum, stot = avg_state
        w = f32(self.a) + f32(t)
        w = w * w
        wsum = tree_map(lambda s, p: s + float(w) * p.to(torch.float32),
                        wsum, params)
        return (wsum, float(f32(stot) + w))

    def value(self, avg_state):
        wsum, stot = avg_state
        denom = float(max(f32(stot), f32(1e-30)))
        return tree_map(lambda s: s / denom, wsum)


def S_T(T: int, a: float) -> float:
    """Closed form S_T = sum_{t=0}^{T-1} (a+t)^2 from Lemma 3.3."""
    return T / 6.0 * (2 * T * T + 6 * a * T - 3 * T + 6 * a * a - 6 * a + 1)


def theorem_bound(
    T: int, d: int, k: float, mu: float, L: float, G2: float, x0_dist2: float,
    alpha: float = 5.0,
) -> float:
    """RHS of (9) — the explicit Theorem 2.4 suboptimality bound.

    Useful for sanity checks: measured E f(x_bar) - f* must lie below this.
    """
    a = theoretical_shift(d, k, alpha)
    st = S_T(T, a)
    c_alpha = 4 * alpha / (alpha - 4.0)
    term1 = 4 * T * (T + 2 * a) / (mu * st) * G2
    term2 = mu * a**3 / (8 * st) * x0_dist2
    term3 = 64 * T * (1 + 2 * L / mu) / (mu * st) * c_alpha * (d / k) ** 2 * G2
    return term1 + term2 + term3
