"""Training telemetry sink: loss health, bytes, and compile accounting.

The port's copy of the reference's stdlib-only sink
(``repro.utils.telemetry``), kept verbatim below this note so that both
drivers report alike; the pod-k and jit-cache records stay empty in the
port, which has neither.

``Telemetry`` is the one observer ``launch.train.train()`` feeds every
step (in the style of HomebrewNLP's ``wandblog.py``): it keeps a
rolling-window loss median, flags spikes (loss far above the window
median) and non-finite losses — raising a NAMED error instead of
letting the loop train to its step budget on garbage — tracks the
exact per-step cross-worker/cross-pod byte accounting
(``distributed.bucketed_message_bytes`` values, fed by the driver),
records the per-bucket pod ks after every live refresh, and samples the
jit-cache population each step (absorbing the driver's historical
ad-hoc ``diagnostics=`` dict, whose keys it still emits verbatim).

Telemetry is **observe-only**: it reads host floats after the step has
already been dispatched and never touches params, memory, or the
computation — enabling it is bitwise inert on training state AND inert
on wall-clock: the driver drains each step's device loss only after the
next step is dispatched, so the blocking host read never stalls the
device queue (step records in the JSONL series therefore lag events
like ``pod_refresh`` by one step; every record carries its own ``step``
field).

Series go to a JSONL file when ``TelemetryConfig.jsonl_path`` is set
(one record per step, one per event), and ``summary()`` returns the
scenario-health dict the ``matrix`` bench gates in CI.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
from collections import deque
from typing import Callable, List, Optional, Sequence


class NonFiniteLossError(RuntimeError):
    """Loss went NaN/inf. Carries the offending step index; when raised
    out of ``launch.train.train()``, ``history`` additionally carries
    the partial ``(step, loss)`` log accumulated before the stop."""

    def __init__(self, step: int, loss: float):
        self.step = step
        self.loss = loss
        self.history: Optional[list] = None
        super().__init__(
            f"non-finite loss {loss!r} at step {step} — stopping instead "
            "of training to the step budget on garbage (pass "
            "TelemetryConfig(stop_on_nonfinite=False) to observe only)"
        )


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    # rolling loss-median window (also the first/last summary window)
    window: int = 8
    # a loss is a SPIKE when it exceeds spike_factor * (window median);
    # detection arms once the window holds >= min_history samples
    spike_factor: float = 4.0
    min_history: int = 3
    # non-finite loss raises NonFiniteLossError (the named early stop);
    # False records it and keeps observing
    stop_on_nonfinite: bool = True
    # optional spike early-stop budget: after this many spikes,
    # ``stop_reason`` is set and the driver breaks out of the loop
    # (None = never stop on spikes, they are only counted)
    max_spikes: Optional[int] = None
    # one JSON record per step/event appended here (None = in-memory only)
    jsonl_path: Optional[str] = None


class RollingMedian:
    """Median over the last ``window`` pushed values.

    Tiny windows (telemetry uses <= ~16) make the O(window log window)
    re-sort per read irrelevant; correctness and zero deps win.
    """

    def __init__(self, window: int):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._buf: deque = deque(maxlen=window)

    def push(self, x: float) -> float:
        self._buf.append(float(x))
        return self.value

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def value(self) -> Optional[float]:
        if not self._buf:
            return None
        return float(statistics.median(self._buf))


def is_spike(x: float, median: Optional[float], factor: float) -> bool:
    """True iff ``x`` is in excess of ``factor`` times the window median.

    A non-finite ``x`` is a *non-finite* event, not a spike; an empty or
    non-finite median (no history yet) can never flag.
    """
    if median is None or not math.isfinite(median) or not math.isfinite(x):
        return False
    return x > factor * median


class SpikeDetector:
    """Rolling-median spike detector: ``observe(x)`` -> flagged?

    Every finite observation enters the window AFTER detection, so a
    value is always judged against the median of its predecessors and
    the properties the tests pin hold: a constant stream keeps a
    constant median and never flags; a value is flagged iff it exceeds
    ``factor`` times the current window median (once ``min_history``
    samples arrived).
    """

    def __init__(self, window: int = 8, factor: float = 4.0,
                 min_history: int = 3):
        self.median = RollingMedian(window)
        self.factor = factor
        self.min_history = min_history

    def observe(self, x: float) -> bool:
        armed = len(self.median) >= self.min_history
        flagged = armed and is_spike(x, self.median.value, self.factor)
        if math.isfinite(x):
            self.median.push(x)
        return flagged


class Telemetry:
    """Per-run telemetry sink. The driver calls ``step()`` every
    optimizer/local step and ``pod_refresh()`` at each live pod-k
    refresh; ``summary()``/``diagnostics()`` read everything back."""

    def __init__(self, config: TelemetryConfig = TelemetryConfig(),
                 printer: Callable[[str], None] = print):
        self.config = config
        self._print = printer
        self._detector = SpikeDetector(config.window, config.spike_factor,
                                       config.min_history)
        self.losses: List[float] = []
        self.spike_steps: List[int] = []
        self.nonfinite_step: Optional[int] = None
        self.stop_reason: Optional[str] = None
        self.cache_sizes: List[Optional[int]] = []
        self.refresh_schedule: List[tuple] = []
        self.initial_pod_ks: Optional[tuple] = None
        self.bytes_per_step: Optional[dict] = None
        self._bytes_total: dict = {}
        self._fh = None
        if config.jsonl_path:
            self._fh = open(config.jsonl_path, "w")

    # -- ingestion ----------------------------------------------------------

    def _write(self, rec: dict) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")

    def set_bytes_per_step(self, acct: Optional[dict]) -> None:
        """Install the CURRENT per-step byte accounting (the exact
        ``bucketed_message_bytes`` / ``amortized_bytes_per_step`` dict,
        e.g. ``{"intra", "cross", "total"}``). The driver refreshes it
        whenever the live pod ks change; ``step()`` accumulates it."""
        self.bytes_per_step = dict(acct) if acct is not None else None

    def step(self, i: int, loss: float, *, aux: Optional[float] = None,
             cache_size: Optional[int] = None, log: bool = False) -> dict:
        """Record one step. Returns the record; raises
        ``NonFiniteLossError`` on NaN/inf loss when configured to."""
        loss = float(loss)
        median_before = self._detector.median.value
        spike = self._detector.observe(loss)
        finite = math.isfinite(loss)
        self.losses.append(loss)
        self.cache_sizes.append(cache_size)
        if self.bytes_per_step is not None:
            for k, v in self.bytes_per_step.items():
                self._bytes_total[k] = self._bytes_total.get(k, 0) + v
        if spike:
            self.spike_steps.append(i)
            self._print(
                f"telemetry: loss spike at step {i}: {loss:.4f} vs "
                f"window median {median_before:.4f} "
                f"(> x{self.config.spike_factor:g})"
            )
            if (self.config.max_spikes is not None
                    and len(self.spike_steps) >= self.config.max_spikes
                    and self.stop_reason is None):
                self.stop_reason = (
                    f"loss spiked {len(self.spike_steps)} time(s) "
                    f"(max_spikes={self.config.max_spikes}), last at "
                    f"step {i}"
                )
        rec = {
            "step": i, "loss": loss,
            "median": self._detector.median.value,
            "spike": bool(spike), "finite": bool(finite),
        }
        if aux is not None:
            rec["aux"] = float(aux)
        if cache_size is not None:
            rec["cache_size"] = cache_size
        if self.bytes_per_step is not None:
            rec["bytes"] = self.bytes_per_step
        self._write(rec)
        if log:
            self._print(f"step {i:5d}  loss {loss:.4f}")
        if not finite:
            if self.nonfinite_step is None:
                self.nonfinite_step = i
            if self.stop_reason is None:
                self.stop_reason = f"non-finite loss at step {i}"
            if self.config.stop_on_nonfinite:
                # flush (not close): the record is durable on disk, but
                # a caller-owned sink stays open so it can be reused
                # across runs / keep receiving events after the raise
                if self._fh is not None:
                    self._fh.flush()
                raise NonFiniteLossError(i, loss)
        return rec

    def pod_refresh(self, i: int, pod_ks: Sequence[int],
                    cross_bytes: Optional[float] = None) -> None:
        """Record a live pod-k refresh (the applied per-bucket ks and,
        when known, the effective cross-pod bytes they buy)."""
        ks = tuple(int(k) for k in pod_ks)
        self.refresh_schedule.append((i, ks))
        rec = {"event": "pod_refresh", "step": i, "pod_ks": list(ks)}
        if cross_bytes is not None:
            rec["cross_bytes"] = cross_bytes
        self._write(rec)

    @property
    def should_stop(self) -> bool:
        """Early-stop hook for the driver: True once the spike budget
        is exhausted (non-finite stop RAISES instead, so a bare
        stop_reason — e.g. an observed non-finite loss with
        ``stop_on_nonfinite=False`` — does not stop the loop)."""
        return (self.config.max_spikes is not None
                and len(self.spike_steps) >= self.config.max_spikes)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- readback -----------------------------------------------------------

    def _window_median(self, tail: bool) -> Optional[float]:
        w = self.config.window
        finite = [x for x in self.losses if math.isfinite(x)]
        if not finite:
            return None
        chunk = finite[-w:] if tail else finite[:w]
        return float(statistics.median(chunk))

    def summary(self) -> dict:
        """Scenario-health dict: what the ``matrix`` bench records per
        (arch, preset) cell and ``check_matrix`` gates in CI."""
        first = self._window_median(tail=False)
        last = self._window_median(tail=True)
        return {
            "steps": len(self.losses),
            "loss_first_median": first,
            "loss_last_median": last,
            "median_decreased": (first is not None and last is not None
                                 and last < first),
            "spikes": len(self.spike_steps),
            "spike_steps": list(self.spike_steps),
            "nonfinite": self.nonfinite_step is not None,
            "nonfinite_step": self.nonfinite_step,
            "stop_reason": self.stop_reason,
            "bytes_per_step": self.bytes_per_step,
            "bytes_total": dict(self._bytes_total) or None,
            "pod_refreshes": len(self.refresh_schedule),
            "pod_refresh_schedule": [
                [i, list(ks)] for i, ks in self.refresh_schedule],
            "cache_size_final": (self.cache_sizes[-1]
                                 if self.cache_sizes else None),
        }

    def steady_state_recompiles(self, local_steps: int = 1) -> Optional[int]:
        """Jit-cache entries added after the first full sync round
        settles — REAL recompiles (a live pod-k refresh must never add
        one). At H == 1 the baseline sits after the second step (the
        first call traces; the second may re-trace once as donated/
        committed shardings settle); at H > 1 both the accum and sync
        steps need their trace + settle, so the baseline is the end of
        the second round (index 2H - 1)."""
        sizes = self.cache_sizes
        if not sizes or sizes[0] is None:
            return None
        base = sizes[min(2 * max(1, local_steps) - 1, len(sizes) - 1)]
        return sizes[-1] - base

    def diagnostics(self, local_steps: int = 1) -> dict:
        """The historical ``train(diagnostics=)`` dict, verbatim keys —
        benches and tests that read it keep working unchanged."""
        return {
            "step_cache_sizes": list(self.cache_sizes),
            "step_cache_size": (self.cache_sizes[-1]
                                if self.cache_sizes else None),
            "pod_refresh_schedule": list(self.refresh_schedule),
            "initial_pod_ks": self.initial_pod_ks,
            "steady_state_recompiles":
                self.steady_state_recompiles(local_steps),
        }
