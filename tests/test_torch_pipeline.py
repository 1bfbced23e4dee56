"""The port's bucket pipeline (``repro_torch.core.pipeline``) against the
reference's (``repro.core.pipeline``), in process:

* the planner: ``plan_schedule`` gives the reference's order on drawn
  chains of every stage kind (COMPUTE, COMM, REPACK, QUANT mixes, 1-8
  buckets, depth 1-4), and ``validate_schedule`` rejects the same
  violations with the same errors;
* the in-device executor: ``run_schedule`` gives the same bits at depth
  None, 1, 2 and 3, runs the stages in the planned order, resolves a
  comm stage's ``Pending`` right before its bucket's next stage, and
  consumes its inputs;
* the host executor over ``EmulatedLink``: the same results at depth 1
  and 2, depth 2 under depth 1 by the reference test's wide margin, and
  the link serialises its transfers;
* ``repack_transport(link=)``: the padded buffer bit for bit, its bytes
  the reference's ``message_nbytes`` at the live k and the cross term of
  ``bucketed_message_bytes(pod_ks=)``;
* the syncs: ``SyncConfig.overlap`` None, False and True give bitwise
  equal updates, memory, bytes and level bytes at one worker on every
  path (per-leaf and bucketed; flat, two-level static, two-level
  runtime-k across a live-k switch with repack on and off), both wires,
  float32 and bf16 wire values. The two-level chain runs on a (1, 1)
  layout whose gathers are the identity (no process group);
* the self-checks at one worker, their byte entries against the
  reference's accounting.
"""
import dataclasses
import time
import warnings

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import buckets as rbk
from repro.core import encoding as renc
from repro.core import pipeline as rpl
from repro.core.distributed import SyncConfig as RefSyncConfig
from repro.core.distributed import bucketed_message_bytes as ref_bucket_bytes
from repro_torch.core import buckets as bk
from repro_torch.core import encoding as enc
from repro_torch.core import pipeline as pl
from repro_torch.core.distributed import (
    SyncConfig,
    bucketed_sync_gradients,
    repack_transport,
    sparse_sync_gradients,
)
from repro_torch.core.selfcheck import (
    bitwise_equal,
    overlap_selfcheck,
    repack_selfcheck,
)
from repro_torch.kernels.ref import row_topk_ref
from repro_torch.kernels.topk_select import mask_live_k
from repro_torch.launch.mesh import Layout

E, G, R, Q = pl.COMPUTE, pl.COMM, pl.REPACK, pl.QUANT
# the reference's chains: flat, two-level, two-level with the repack
# boundary, dense; and the quantized forms of the first two
SHAPES = [(E, G, E), (E, G, E, G, E), (E, G, E, R, G, E), (G,),
          (E, Q, G, E), (E, Q, G, E, Q, R, G, E)]


def _kinds(n, seed):
    rng = np.random.default_rng(seed)
    return [SHAPES[i] for i in rng.integers(0, len(SHAPES), n)]


@settings(max_examples=40, deadline=None)
@given(n=st.integers(min_value=1, max_value=8),
       depth=st.integers(min_value=1, max_value=4),
       seed=st.integers(min_value=0, max_value=10**6))
def test_plan_schedule_matches_reference(n, depth, seed):
    kinds = _kinds(n, seed)
    order = pl.plan_schedule(kinds, depth)
    assert order == rpl.plan_schedule(kinds, depth)
    pl.validate_schedule(order, kinds, depth)
    assert pl.plan_schedule(kinds, 1) == [
        (b, s) for b in range(n) for s in range(len(kinds[b]))]


def _violations():
    kinds = [SHAPES[0]] * 4
    good = pl.plan_schedule(kinds, 1)
    swapped = list(good)
    swapped[0], swapped[1] = swapped[1], swapped[0]
    return {
        "truncated": (good[:-1], kinds, 1),
        "stage order": (swapped, kinds, 1),
        "window": (pl.plan_schedule(kinds, 2), kinds, 1),
        "duplicate": (good[:-1] + [good[0]], kinds, 1),
    }


@pytest.mark.parametrize("case", sorted(_violations()))
def test_validate_schedule_rejects_the_reference_violations(case):
    order, kinds, depth = _violations()[case]
    with pytest.raises(AssertionError) as ours:
        pl.validate_schedule(order, kinds, depth)
    with pytest.raises(AssertionError) as ref:
        rpl.validate_schedule(order, kinds, depth)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("kinds,depth,match", [
    ([SHAPES[0]], 0, "depth"), ([("compute", "mystery")], 1, "kind")])
def test_plan_schedule_rejects_bad_input_as_the_reference(kinds, depth,
                                                          match):
    for mod in (pl, rpl):
        with pytest.raises(ValueError, match=match):
            mod.plan_schedule(kinds, depth)


@pytest.mark.parametrize("overlap", [None, False, True])
def test_overlap_depth_matches_reference(overlap):
    assert pl.overlap_depth(overlap) == rpl.overlap_depth(overlap)
    cfg = SyncConfig(overlap=overlap).validate()
    assert cfg.overlap_depth() == pl.overlap_depth(overlap)


class _Issued:
    """A fake collective's work handle: records its wait."""

    def __init__(self, log, b):
        self.log, self.b = log, b

    def wait(self):
        self.log.append(("wait", self.b))


def _toy_chains(n, log):
    """n chains of (E, G, E, G, E) over tensors: local stages are float32
    ops, a comm stage returns a ``Pending`` whose value is a
    value-preserving op (a roll) read only once waited."""
    def local(b, s, f):
        def stage(x):
            log.append(("run", b, s))
            return f(x)
        return stage

    def comm(b, s):
        def stage(x):
            log.append(("run", b, s))
            return pl.Pending([_Issued(log, b)], lambda: torch.roll(x, 1))
        return stage

    inits = [torch.arange(8.0) * (b + 1) for b in range(n)]
    stages = [[local(b, 0, lambda x: torch.sin(x) + 1.0), comm(b, 1),
               local(b, 2, lambda x: x * 2.0), comm(b, 3),
               local(b, 4, lambda x: (x / 3.0, torch.cumsum(x, 0)))]
              for b in range(n)]
    return inits, stages, [SHAPES[1]] * n


@pytest.mark.parametrize("depth", [None, 1, 2, 3])
def test_run_schedule_bits_order_and_waits(depth):
    """Every depth gives the same bits; the stages run in the planned
    order (None: bucket after bucket); each Pending is waited right
    before its bucket's next stage (None: right after its issue); the
    inputs are consumed."""
    n = 4
    log = []
    inits, stages, kinds = _toy_chains(n, log)
    out = pl.run_schedule(inits, stages, kinds, depth)
    assert inits == [None] * n
    want_log = []
    ref_inits, ref_stages, _ = _toy_chains(n, want_log)
    want = pl.run_schedule(ref_inits, ref_stages, kinds, None)
    assert bitwise_equal(out, want)
    plan = (pl.plan_schedule(kinds, depth) if depth is not None
            else [(b, s) for b in range(n) for s in range(5)])
    assert [e[1:] for e in log if e[0] == "run"] == plan
    for i, e in enumerate(log):
        if e[0] == "wait":
            b = e[1]
            if depth is None:
                assert log[i - 1][:2] == ("run", b)
            else:
                nxt = next(x for x in log[i + 1:] if x[0] == "run")
                assert nxt[1] == b
    if depth == 2:  # a younger bucket's stage runs while a gather is out
        first_wait = next(i for i, e in enumerate(log) if e[0] == "wait")
        assert any(e[0] == "run" and e[1] == 1 for e in log[:first_wait])


def test_host_pipeline_matches_and_overlaps():
    """The host executor over an ``EmulatedLink`` (the reference test):
    the same results at depth 1 and 2, and depth 2 hides the transfer
    latency behind the next bucket's compute: with compute time ~= wire
    time the pipelined wall clock lands well under the serial sum."""
    n, delay = 4, 0.03
    rng = np.random.default_rng(0)
    data = [torch.from_numpy(rng.standard_normal(64).astype(np.float32))
            for _ in range(n)]

    def make(link):
        def compute1(x):
            time.sleep(delay)
            return torch.tanh(x)

        def comm(x):
            return link.transfer(x, x.numel() * 4)

        def compute2(x):
            return (x * 2.0).sum()

        return [[compute1, comm, compute2] for _ in range(n)]

    def run(depth):
        link = pl.EmulatedLink(latency_s=delay)
        t0 = time.monotonic()
        out = pl.run_host_pipeline(list(data), make(link), [SHAPES[0]] * n,
                                   depth)
        return out, time.monotonic() - t0

    out1, t1 = run(1)
    out2, t2 = run(2)
    assert bitwise_equal(out1, out2)
    # serial: n * (compute + wire) ~ 8 * delay; pipelined ~ (n + 1) * delay
    assert t2 < t1 - 1.5 * delay, (t1, t2)


def test_emulated_link_serializes_transfers():
    link = pl.EmulatedLink(latency_s=0.01, bandwidth_Bps=1e6)
    f1 = link.transfer("a", 10_000)  # 10 ms latency + 10 ms on the wire
    f2 = link.transfer("b", 10_000)
    assert f1.result() == "a" and f2.result() == "b"
    (i1, d1), (i2, d2) = link.transfers
    assert d2 >= d1 + link.delay_for(10_000) - 1e-6  # no double booking
    assert link.delay_for(10_000) == pytest.approx(
        rpl.EmulatedLink(0.01, 1e6).delay_for(10_000)) == pytest.approx(0.02)


def _tree():
    rng = np.random.default_rng(5)
    return {"w": rng.standard_normal((48, 256)).astype(np.float32),
            "b": rng.standard_normal(40).astype(np.float32)}


@pytest.mark.parametrize("live", [1, 4, 12])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_repack_transport_link_bytes_match_reference(value_dtype, live):
    """The link form ships the compacted message and repads it on
    ``.result()`` bit for bit; its bytes are the reference's
    ``message_nbytes`` at the live k and the sparse cross term of its
    ``bucketed_message_bytes(pod_ks=)``."""
    tree = _tree()
    plan = bk.make_plan({k: torch.from_numpy(v) for k, v in tree.items()},
                        cols=128, dense_below=64)
    rplan = rbk.make_plan(tree, cols=128, dense_below=64)
    b = next(i for i, s in enumerate(plan.buckets) if s.kind == "sparse")
    spec = plan.buckets[b]
    cfg = SyncConfig.preset("pod_budgeted", ratio=0.05, pod_axis="pod",
                            bucket_cols=128, value_dtype=value_dtype)
    k_max = cfg.pod_k_max_for_bucket(b, spec.cols, 2)
    x = torch.from_numpy(np.random.default_rng(live).standard_normal(
        spec.shape).astype(np.float32))
    vals, idx = mask_live_k(*row_topk_ref(x, k_max), live)
    wspec = enc.WireSpec(spec.rows, spec.cols, k_max, value_dtype)
    buf = enc.encode(wspec, vals, idx, live_n=live)
    link = pl.EmulatedLink(latency_s=1e-4)
    fut, nbytes = repack_transport(wspec, buf, link=link, live_n=live)
    assert bitwise_equal(fut.result(), buf)
    assert link.transfers and len(link.transfers) == 1
    ks = tuple(live if s.kind == "sparse" else 1 for s in plan.buckets)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rcfg = RefSyncConfig.preset("pod_budgeted", ratio=0.05,
                                    pod_axis="pod", bucket_cols=128,
                                    value_dtype=value_dtype)
    cross = ref_bucket_bytes(rcfg, rplan, by_level=True, pod_ks=ks)["cross"]
    dense = sum(s.rows * s.cols * 4 for s in rplan.buckets
                if s.kind == "dense")
    assert nbytes == renc.message_nbytes(spec.rows, spec.cols, live,
                                         value_dtype, "packed")
    assert nbytes == cross - dense


ONE = Layout(n_pods=1, n_data=1, rank=0, data_group=None, pod_group=None)
# the sync paths at one worker: (path, chain)
PATHS = [("bucketed", "flat"), ("bucketed", "static"),
         ("bucketed", "dynamic"), ("bucketed", "dynamic repack"),
         ("per-leaf", "flat"), ("per-leaf", "static")]


def _sync_runs(path, chain, wire, vd, overlap):
    """Two chained steps of the sync at one worker (a live-k switch 9 ->
    4 on the runtime-k chains): every step's update, bytes and level
    bytes, and the last memory."""
    tree = _tree()
    grads = {k: torch.from_numpy(v * 0.7 + 0.01) for k, v in tree.items()}
    cfg = SyncConfig(ratio=0.05, bucketed=path == "bucketed",
                     bucket_cols=128, dense_below=64, wire=wire,
                     value_dtype=vd, overlap=overlap)
    if chain != "flat":
        cfg = dataclasses.replace(cfg, strategy="hierarchical",
                                  pod_axis="pod", pod_ratio=0.1,
                                  pod_dynamic=chain.startswith("dynamic"),
                                  repack=chain == "dynamic repack")
    layout = ONE if chain != "flat" else None
    rng = np.random.default_rng(7)
    if path == "bucketed":
        plan = bk.make_plan(grads, cols=128, dense_below=64)
        mem = [torch.from_numpy(rng.standard_normal(s.shape).astype(
            np.float32)) for s in plan.buckets]
    else:
        mem = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
            np.float32)) for k, v in tree.items()}
    out = []
    for k_live in (9, 4):
        level = {"intra": 0, "cross": 0}
        if path == "bucketed":
            ks = (tuple(k_live if s.kind == "sparse" else 1
                        for s in plan.buckets) if cfg.pod_dynamic else None)
            upd, mem, nbytes = bucketed_sync_gradients(
                cfg, plan, mem, grads, 0.3, layout=layout, pod_ks=ks,
                level_bytes=level)
            mem = list(mem)
        else:
            upd, mem, nbytes = sparse_sync_gradients(
                cfg, mem, grads, 0.3, {"w": 0, "b": None}, layout=layout)
        out.append((upd, nbytes, level))
    return out, mem


@pytest.mark.parametrize("vd", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["unpacked", "packed"])
@pytest.mark.parametrize("path,chain", PATHS)
def test_overlap_modes_are_bitwise_equal_at_one_worker(path, chain, wire,
                                                       vd):
    (steps, mem) = _sync_runs(path, chain, wire, vd, None)
    for overlap in (False, True):
        got_steps, got_mem = _sync_runs(path, chain, wire, vd, overlap)
        assert bitwise_equal([s[0] for s in got_steps],
                             [s[0] for s in steps])
        assert bitwise_equal(got_mem, mem)
        assert [s[1:] for s in got_steps] == [s[1:] for s in steps]


@pytest.mark.parametrize("wire", ["unpacked", "packed"])
def test_selfchecks_at_one_worker_match_reference_bytes(wire):
    """Both self-checks on a (1, 1) layout: every flag True, and the
    repack check's (padded, live) cross-pod bytes the reference's
    accounting of the same message at n_data 1."""
    ov = overlap_selfcheck(ONE, wire=wire)
    assert ov == {"flat_bitwise": True, "hierarchical_bitwise": True,
                  "pod_dynamic_bitwise": True, "bitwise_all": True}
    rp = repack_selfcheck(ONE)
    assert all(rp[k] for k in ("repack_bitwise",
                               "transport_roundtrip_bitwise",
                               "transport_accounting_exact"))
    rows, cols, k_row = 48, 128, round(0.05 * 128)
    k_max = max(1 * k_row, 9)  # n_data * k_row, never below the pod k 9
    assert rp["padded_vs_live_bytes"] == [
        renc.WireSpec(rows, cols, k_max).nbytes,
        renc.message_nbytes(rows, cols, 4, "float32", "packed")]
