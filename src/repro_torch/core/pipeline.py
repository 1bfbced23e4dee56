"""Software-pipelined bucket schedule: overlap encode / gather / decode
(port of ``repro.core.pipeline``).

The sync (``core.distributed``) runs one independent stage chain per
bucket or leaf, alternating compute (select + wire encode, decode +
densify) and communication (the all-gather). Run strictly bucket after
bucket, the wire sits idle while a bucket computes and the device sits
idle while it gathers. This module plans and executes a DOUBLE-BUFFERED
schedule instead: while bucket b's gather is in flight, bucket b+1 runs
its select and encode, the classic software pipeline, parameterized by
``depth`` (how many buckets may be in flight at once; 1 is strict
sequential, 2 the double buffer).

Every entry point shares ONE planner, so the schedule the tests verify is
the schedule both executors run:

* ``plan_schedule(kinds, depth)``: per-bucket stage kinds in, a total
  order of (bucket, stage) emissions out. The planner walks the oldest
  in-flight bucket up to and through its next comm issue, then advances
  younger in-flight buckets' local stages (the work that hides behind the
  comm), and admits bucket b only after bucket b-depth fully retired: the
  depth-bucket memory bound.

* ``run_schedule(...)``: the in-device executor. Stages run eagerly in
  ``plan_schedule`` order. A comm stage issues its collectives
  asynchronously and returns a ``Pending``; the bucket's next stage
  resolves it (waits on the collectives' work handles) exactly where the
  planner put that stage, so younger buckets' kernels are issued while
  the gather is in flight. The reference's ``optimization_barrier``
  has no counterpart: eager PyTorch issues work in program order, so the
  order of emission is the barrier. Every value is computed by the same
  ops at every depth, which is why ``overlap=True`` gives the same bits
  as ``overlap=False`` and ``None``.

* ``run_host_pipeline(...)``: the host executor for transports outside
  the step (a host link, the emulated-latency wire ``EmulatedLink``).
  Comm stages return a future; the executor resolves it lazily, exactly
  where the planner scheduled the dependent stage, so at depth 1 every
  transfer is issue-then-wait and at depth 2 the transfer of bucket b
  overlaps the compute of bucket b+1.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

COMPUTE = "compute"
COMM = "comm"
# A repack boundary stage: the header-aware transport's compaction of a
# k-padded wire buffer down to its live payload right before the slow
# link (see ``core.encoding.repack``). Schedules like compute (local work
# that hides behind an in-flight transfer) but is named so chains and
# tests can assert where the byte shrink happens. Inside a step the stage
# is the identity on the buffer; the host transport's repack
# (``distributed.repack_transport``) does the real byte reduction.
REPACK = "repack"
# A quantization stage: stochastic rounding of the selected values into
# wire codes (Qsparse-local-SGD's Q step). Local work that schedules
# exactly like compute, named so stage chains and tests can assert where
# the value precision drops.
QUANT = "quant"


def overlap_depth(overlap: Optional[bool]) -> Optional[int]:
    """Map ``SyncConfig.overlap`` to a pipeline depth: ``None`` keeps the
    plain bucket-after-bucket emission, ``False`` pins the strict
    sequential schedule (depth 1), ``True`` double-buffers (depth 2)."""
    if overlap is None:
        return None
    return 2 if overlap else 1


def plan_schedule(kinds: Sequence[Sequence[str]], depth: int
                  ) -> List[Tuple[int, int]]:
    """Total order of (bucket, stage) emissions for the given depth.

    ``kinds[b][s]`` is "compute", "comm", "quant" or "repack" (quant and
    repack stages schedule exactly like compute: local work that hides
    behind an in-flight transfer). At most ``depth`` buckets are in flight
    at any point; bucket b is admitted only once bucket b-depth has fully
    retired. Depth 1 reproduces the strict sequential order; depth 2
    produces the classic double buffer (for per-bucket kinds [E, G, D]:
    E0 G0 E1 D0 G1 E2 D1 ...: bucket b+1's encode hides behind bucket b's
    gather).
    """
    if depth < 1:
        raise ValueError(f"pipeline depth must be >= 1, got {depth}")
    n = len(kinds)
    for b, ks in enumerate(kinds):
        for s, kind in enumerate(ks):
            if kind not in (COMPUTE, COMM, QUANT, REPACK):
                raise ValueError(
                    f"unknown stage kind {kind!r} at bucket {b} stage {s}")
    order: List[Tuple[int, int]] = []
    ptr = [0] * n
    window: List[int] = []
    next_b = 0
    while next_b < n or window:
        while len(window) < depth and next_b < n:
            window.append(next_b)
            next_b += 1
        b = window[0]
        # walk the oldest bucket through its pending local stages ...
        while ptr[b] < len(kinds[b]) and kinds[b][ptr[b]] != COMM:
            order.append((b, ptr[b]))
            ptr[b] += 1
        # ... and through its next comm issue, hiding younger buckets'
        # local stages behind the in-flight transfer
        if ptr[b] < len(kinds[b]):
            order.append((b, ptr[b]))
            ptr[b] += 1
            for b2 in window[1:]:
                while (ptr[b2] < len(kinds[b2])
                       and kinds[b2][ptr[b2]] != COMM):
                    order.append((b2, ptr[b2]))
                    ptr[b2] += 1
        if ptr[b] == len(kinds[b]):
            window.pop(0)
    return order


def validate_schedule(order: Sequence[Tuple[int, int]],
                      kinds: Sequence[Sequence[str]], depth: int) -> None:
    """Raise unless ``order`` is a legal depth-bounded schedule of
    ``kinds``: a permutation of every (bucket, stage), per-bucket stages
    ascending, and no bucket starting before bucket b-depth retired."""
    n = len(kinds)
    want = {(b, s) for b in range(n) for s in range(len(kinds[b]))}
    if len(order) != len(want) or set(order) != want:
        raise AssertionError(
            f"schedule is not a permutation of all stages: {order}")
    pos = {bs: i for i, bs in enumerate(order)}
    for b in range(n):
        for s in range(1, len(kinds[b])):
            if pos[(b, s)] < pos[(b, s - 1)]:
                raise AssertionError(
                    f"bucket {b} stage {s} scheduled before stage {s - 1}")
    for b in range(depth, n):
        started = pos[(b, 0)]
        retired = pos[(b - depth, len(kinds[b - depth]) - 1)]
        if started < retired:
            raise AssertionError(
                f"bucket {b} started before bucket {b - depth} retired "
                f"(depth {depth} window violated)")


class Pending:
    """A comm stage's in-flight result: the collectives' work handles
    (anything with ``.wait()``) and ``then``, which builds the state the
    bucket's next stage reads. ``result()`` waits on every handle, then
    returns ``then()``. ``then`` holds the collectives' inputs and
    outputs, so they stay referenced until the wait."""

    def __init__(self, works: Sequence, then: Callable[[], object]):
        self._works = list(works)
        self._then = then

    def result(self):
        for w in self._works:
            w.wait()
        self._works = []
        return self._then()


def _is_future(x) -> bool:
    return callable(getattr(x, "result", None))


def _resolve(x):
    return x.result() if _is_future(x) else x


def run_schedule(inits: list, stage_lists: Sequence[Sequence[Callable]],
                 kinds: Sequence[Sequence[str]],
                 depth: Optional[int]) -> list:
    """Run every bucket's stage chain in the planned order (in-device).

    ``inits[b]`` is bucket b's input (fed to stage 0); each stage is a
    callable ``state -> state`` (a comm stage's may be a ``Pending``,
    resolved right before the bucket's next stage reads it); the final
    state is returned per bucket, resolved. ``inits`` is consumed: each
    entry is dropped once its bucket's stage 0 has run, so a bucket's
    input buffers are freed as the window moves on (the caller keeps no
    other reference to what it wants freed).

    ``depth=None`` runs the chains bucket by bucket, each collective
    waited right after its issue: the synchronous op sequence. An integer
    depth emits in ``plan_schedule`` order, so at depth >= 2 bucket b's
    gather is in flight while younger buckets compute; in eager PyTorch
    depth 1 is the same order as None."""
    n = len(inits)
    if depth is None:
        order = [(b, s) for b in range(n) for s in range(len(kinds[b]))]
        wait_now = True
    else:
        order = plan_schedule(kinds, depth)
        wait_now = False
    state: list = [None] * n
    done: list = [None] * n
    for b, s in order:
        if s == 0:
            x, inits[b] = inits[b], None
        else:
            x, state[b] = _resolve(state[b]), None
        out = stage_lists[b][s](x)
        del x
        if wait_now:
            out = _resolve(out)
        if s == len(stage_lists[b]) - 1:
            done[b] = out
        else:
            state[b] = out
    return [_resolve(d) for d in done]


def run_host_pipeline(inits: Sequence,
                      stage_lists: Sequence[Sequence[Callable]],
                      kinds: Sequence[Sequence[str]], depth: int) -> list:
    """Host-side executor on the SAME planner: comm stages may return a
    future (anything with ``.result()``); it is resolved lazily, right
    where the schedule runs the dependent stage, so the transfer's
    latency is exposed (depth 1) or hidden behind younger buckets'
    compute (depth >= 2) exactly as planned. Returns each bucket's final
    state (futures resolved)."""
    n = len(inits)
    order = plan_schedule(kinds, depth)
    state: list = [None] * n
    done: list = [None] * n
    for b, s in order:
        x = inits[b] if s == 0 else state[b]
        if _is_future(x):
            x = x.result()
        out = stage_lists[b][s](x)
        if s == len(stage_lists[b]) - 1:
            done[b] = out
        else:
            state[b] = out
    return [d.result() if _is_future(d) else d for d in done]


class EmulatedLink:
    """A wire with real wall-clock latency for the host pipeline.

    ``transfer(payload, nbytes)`` returns a future that resolves to
    ``payload`` after ``latency_s + nbytes / bandwidth_Bps`` of real time,
    one transfer at a time (a single serialized link, like a NIC).
    Drives the host executor to measure the schedule's overlap; tests use
    it with small latencies to assert ordering."""

    def __init__(self, latency_s: float = 0.0,
                 bandwidth_Bps: Optional[float] = None):
        self.latency_s = float(latency_s)
        self.bandwidth_Bps = bandwidth_Bps
        self._lock = threading.Lock()
        self._busy_until = 0.0
        self.transfers: List[Tuple[float, float]] = []  # (issue, done)

    def delay_for(self, nbytes: int) -> float:
        d = self.latency_s
        if self.bandwidth_Bps:
            d += nbytes / self.bandwidth_Bps
        return d

    def transfer(self, payload, nbytes: int):
        delay = self.delay_for(nbytes)
        issue = time.monotonic()
        with self._lock:
            # a single serialized link: a transfer starts only when the
            # previous one has drained
            start = max(issue, self._busy_until)
            ready = start + delay
            self._busy_until = ready
            self.transfers.append((issue, ready))

        class _F:
            def result(self_f):
                now = time.monotonic()
                if ready > now:
                    time.sleep(ready - now)
                return payload

        return _F()
