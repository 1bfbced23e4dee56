"""Fan-out of one trainer delta stream to N serving replicas (port of
``repro.launch.fanout``).

``launch.delta_stream`` turns the trainer's per-step parameter update
into ONE packed wire message set; a :class:`FanoutHub` sits between the
trainer's ``delta_sink`` and any number of replicas:

* **replay log**: the hub keeps the last ``log_bound`` steps' wire
  messages as host numpy buffers, keyed by step. A replica that missed
  steps replays the exact bytes it missed, in order; on the float32 tier
  that reproduces the trainer's params bit for bit (``apply_delta`` is
  the trainer's own subtraction).
* **per-replica cursors**: each replica knows its cursor (the next step
  to apply); the hub serves any cursor still in the log. One encoded
  message serves every subscriber.
* **bf16 tier**: replicas subscribed with ``tier="bfloat16"`` get each
  float32 message transcoded ONCE (``encoding.transcode``: values
  rounded, indices untouched) at about half the bytes. Tracking is no
  longer bitwise; the drift after T steps is bounded by the sum of
  the steps' ``||u_t - bf16(u_t)||_inf`` (``drift_bound``).
* **snapshot resync**: a replica whose cursor fell off the log restores
  from the hub's shadow params diff-encoded against the base every
  replica booted from (``encoding.snapshot_encode(cur, base=...)``),
  exact and a few percent of a dense dump under sparse training.

The hub moves uint32 numpy buffers, what a network fabric would move;
its own work (the shadow, the transcodes, the snapshots) runs on the
base params' device. It keeps the base as packed bucket buffers only
(``base`` unpacks views of them), one copy of the params fewer than the
reference's hub.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import buckets as bk
from repro_torch.core import encoding as enc
from repro_torch.launch import delta_stream as ds
from repro_torch.launch.serve import replica_copy


def _host(msg) -> np.ndarray:
    """A wire buffer (a uint32 or int32 tensor, or an array) as a host
    uint32 array of the hub's own."""
    if isinstance(msg, torch.Tensor):
        return msg.detach().view(torch.int32).cpu().numpy().view(np.uint32)
    return np.array(msg).view(np.uint32)


@dataclasses.dataclass
class ReplicaHandle:
    """One subscriber's state. ``params`` are its own tensors (never
    aliased to the trainer's); ``cursor`` is the next step to apply."""

    rid: int
    tier: str  # "float32" (bitwise) | "bfloat16" (lossy, half size)
    cursor: int
    params: Any
    joined_at: int = 0  # the hub's step at join (dense-equivalent cost)
    bytes_rx: int = 0
    steps_replayed: int = 0
    resyncs: int = 0


class FanoutHub:
    """Fan one trainer delta stream out to N replicas (see the module
    docstring). ``dspec`` and ``base_params`` come from the trainer:
    ``make_train_step(...).delta_spec`` and the boot params every replica
    starts from, which the hub packs into its own buffers (the trainer's
    in-place steps cannot reach them)."""

    TIERS = ("float32", "bfloat16")

    def __init__(self, dspec: ds.DeltaSpec, base_params, *,
                 log_bound: int = 64, snapshot_every: Optional[int] = None):
        if log_bound < 1:
            raise ValueError("log_bound must be >= 1")
        if snapshot_every is not None and snapshot_every > log_bound:
            raise ValueError(
                "snapshot_every > log_bound would leave un-replayable gaps")
        self.dspec = dspec
        self.src_tier = dspec.wires[0].value_dtype
        self.base_bufs = bk.pack(dspec.plan, base_params)
        self.device = self.base_bufs[0].device
        self.shadow = replica_copy(base_params)  # tracks the stream exactly
        self.log_bound = log_bound
        self.snapshot_every = snapshot_every
        self.step = 0  # next step index to publish
        self.published_bytes = 0
        self._log: Dict[int, Tuple[np.ndarray, ...]] = {}
        self._transcoded: Dict[str, Dict[int, Tuple[np.ndarray, ...]]] = {}
        self._snap: Optional[Tuple[int, List[enc.SnapshotRecord], int]] = None
        self._replicas: Dict[int, ReplicaHandle] = {}
        self._next_rid = 0
        self._specs: Dict[str, ds.DeltaSpec] = {self.src_tier: dspec}

    @property
    def base(self):
        """The boot params: views into the hub's packed base buffers."""
        return bk.unpack(self.dspec.plan, self.base_bufs, cast=True)

    def _dev(self, msgs) -> List[torch.Tensor]:
        """Host buffers -> int32 views on the hub's device."""
        return [torch.from_numpy(np.ascontiguousarray(m).view(np.int32)).to(
            self.device) for m in msgs]

    # -- trainer side -------------------------------------------------------

    @property
    def log_start(self) -> int:
        """Oldest step still replayable from the log."""
        return max(0, self.step - self.log_bound)

    def publish(self, step: int, msgs: Sequence) -> None:
        """Ingest one trainer step's wire messages (the ``delta_sink``
        signature). Steps must arrive consecutively from 0."""
        if step != self.step:
            raise ValueError(
                f"publish out of order: got step {step}, expected {self.step}")
        if len(msgs) != len(self.dspec.wires):
            raise ValueError(
                f"{len(msgs)} buffers for {len(self.dspec.wires)} buckets")
        host = tuple(_host(m) for m in msgs)
        self._log[step] = host
        # the shadow applies the messages as given when they lie on the
        # hub's device (the same bytes as the host copy)
        dev = [m if isinstance(m, torch.Tensor) and m.device == self.device
               else self._dev([h])[0] for m, h in zip(msgs, host)]
        self.shadow = ds.apply_delta(self.shadow, self.dspec, dev)
        self.step = step + 1
        self.published_bytes += self.dspec.nbytes
        evict = self.log_start
        for s in [s for s in self._log if s < evict]:
            del self._log[s]
            for cache in self._transcoded.values():
                cache.pop(s, None)
        if self.snapshot_every and self.step % self.snapshot_every == 0:
            self._snap = self._take_snapshot()

    # -- snapshots ----------------------------------------------------------

    def _take_snapshot(self) -> Tuple[int, List[enc.SnapshotRecord], int]:
        cur = bk.pack(self.dspec.plan, self.shadow)
        records = []
        for i, b in enumerate(self.base_bufs):
            records.append(enc.snapshot_encode(cur[i], base=b))
            cur[i] = None
        return self.step, records, sum(r.nbytes for r in records)

    def snapshot(self) -> Tuple[int, List[enc.SnapshotRecord], int]:
        """(step, records, nbytes): the shadow params diff-encoded against
        the boot params (exact; dense fallback per bucket)."""
        return self._take_snapshot()

    def _restore(self, records: Sequence[enc.SnapshotRecord]):
        bufs = [enc.snapshot_decode(r, base=b)
                for r, b in zip(records, self.base_bufs)]
        return bk.unpack(self.dspec.plan, bufs, cast=True)

    # -- replica side -------------------------------------------------------

    def join(self, tier: str = "float32") -> ReplicaHandle:
        """Subscribe a new replica: it boots from the base params with its
        cursor at step 0; ``sync`` brings it to the head by replay and/or
        snapshot."""
        if tier not in self.TIERS:
            raise ValueError(f"tier {tier!r} not in {self.TIERS}")
        r = ReplicaHandle(rid=self._next_rid, tier=tier, cursor=0,
                          params=replica_copy(self.base),
                          joined_at=self.step)
        self._next_rid += 1
        self._replicas[r.rid] = r
        return r

    def sync(self, replica: ReplicaHandle) -> ReplicaHandle:
        """Advance ``replica`` to the head of the stream: replay every
        logged step it missed, in order; if its cursor fell off the log,
        resync from a wire-compressed snapshot first (the cached periodic
        one when fresh enough, else one taken now)."""
        while replica.cursor < self.step:
            if replica.cursor < self.log_start:
                self._snapshot_resync(replica)
                continue
            msgs, spec_bytes = self._serve(replica.cursor, replica.tier)
            replica.params = ds.apply_delta(
                replica.params, self._spec(replica.tier), self._dev(msgs))
            replica.cursor += 1
            replica.steps_replayed += 1
            replica.bytes_rx += spec_bytes
        return replica

    def _snapshot_resync(self, replica: ReplicaHandle) -> None:
        snap = self._snap
        if snap is None or snap[0] < self.log_start:
            # cached: every other lagged replica at this step resyncs from
            # the same records
            snap = self._snap = self._take_snapshot()
        step, records, nbytes = snap
        replica.params = None  # drop the stale params before the restore
        replica.params = self._restore(records)
        replica.cursor = step
        replica.bytes_rx += nbytes
        replica.resyncs += 1

    def _spec(self, tier: str) -> ds.DeltaSpec:
        """The tier's static delta spec, derived once."""
        if tier not in self._specs:
            self._specs[tier] = self.dspec.with_value_dtype(tier)
        return self._specs[tier]

    def _serve(self, step: int, tier: str
               ) -> Tuple[Tuple[np.ndarray, ...], int]:
        """The wire buffers of ``step`` in ``tier``'s encoding; a lossy
        tier's are transcoded once per step (on the hub's device) and
        cached for every subscriber."""
        if tier == self.src_tier:
            return self._log[step], self.dspec.nbytes
        cache = self._transcoded.setdefault(tier, {})
        if step not in cache:
            cache[step] = tuple(_host(m) for m in ds.transcode_delta(
                self.dspec, self._dev(self._log[step]), tier))
        return cache[step], self._spec(tier).nbytes

    # -- accounting ---------------------------------------------------------

    def drift_bound(self, tier: str = "bfloat16") -> float:
        """Upper bound on a ``tier`` replica's drift from the trainer over
        the steps still in the log: the sum over steps of the transcode's
        rounding error ``||u_t - tier(u_t)||_inf`` (each step's update
        enters the replica once; float32 accumulation error is second
        order). A step's error is read off its messages' values: the two
        tiers share the index section and a row's indices are distinct,
        so the decoded updates differ exactly there."""
        lossy_spec = self._spec(tier)
        bound = 0.0
        for step in sorted(self._log):
            worst = torch.zeros((), dtype=torch.float32, device=self.device)
            lossy = self._dev(self._serve(step, tier)[0])
            for w, lw, m, lm in zip(self.dspec.wires, lossy_spec.wires,
                                    self._dev(self._log[step]), lossy):
                a = enc.decode(w, m)[0].to(torch.float32)
                b = enc.decode(lw, lm)[0].to(torch.float32)
                worst = torch.maximum(worst, torch.max(torch.abs(a - b)))
            bound += float(worst)
        return bound

    def _dense_equiv(self, r: ReplicaHandle) -> int:
        """What a dense-broadcast world would have shipped this replica:
        one full params dump at join (if it joined mid-stream) and one
        dense refresh per step published since."""
        boot = 1 if r.joined_at > 0 else 0
        return (boot + self.step - r.joined_at) * self.dspec.dense_nbytes

    def stats(self) -> dict:
        """Bytes accounting: what the hub served against what dense
        broadcasts to the same fleet (by each replica's join step) would
        have cost."""
        per_replica = {
            r.rid: {
                "tier": r.tier, "cursor": r.cursor,
                "joined_at": r.joined_at, "bytes_rx": r.bytes_rx,
                "dense_equiv_bytes": self._dense_equiv(r),
                "steps_replayed": r.steps_replayed, "resyncs": r.resyncs,
            }
            for r in self._replicas.values()
        }
        served = sum(r.bytes_rx for r in self._replicas.values())
        dense = sum(self._dense_equiv(r) for r in self._replicas.values())
        if not self._replicas:
            dense = self.step * self.dspec.dense_nbytes
        return {
            "published_steps": self.step,
            "published_bytes": self.published_bytes,
            "log": (self.log_start, self.step),
            "replicas": per_replica,
            "served_bytes": served,
            "dense_broadcast_bytes": dense,
            "fanout_ratio": dense / max(1, served),
        }

