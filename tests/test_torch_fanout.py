"""The port's fan-out hub, snapshot codec and wire checkpoints
(``repro_torch.launch.fanout``, ``core.encoding`` snapshot records,
``checkpoint.Checkpointer``) against the reference's on the CPU: the
cases of ``tests/test_fanout.py`` on the port, and the two packages on
the same inputs.

The hub is driven, as the reference's tests drive theirs, by a synthetic
sparse update stream (numpy draws from a seed, support <= each wire's k':
the trainer's invariant). Held bit for bit: the float32 tier's replicas
and the shadow against the trainer (invariant 5), the port's replicas
against the reference hub's on the reference's messages (both tiers),
the snapshot records' specs and bytes, restored params (invariant 6) and
each package's reading of the other's wire checkpoints. The bf16 tier
stays under ``drift_bound`` (x1.01 + 1e-6, the reference test's slack);
``dropped_frac`` within 1e-6 of the reference's (float32 sums in other
orders).
"""
import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RCheckpointer
from repro.core import buckets as rbk
from repro.core import encoding as renc
from repro.core.distributed import SyncConfig as RSyncConfig
from repro.launch import delta_stream as rds
from repro.launch.fanout import FanoutHub as RFanoutHub
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core import buckets as bk
from repro_torch.core import encoding as enc
from repro_torch.core.distributed import SyncConfig
from repro_torch.data import DeviceBatcher, token_batches
from repro_torch.launch import delta_stream as ds
from repro_torch.launch.fanout import FanoutHub
from repro_torch.launch.serve import replica_copy
from repro_torch.launch.train import (TrainConfig, init_train_state,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_leaves, tree_map

SHAPES = {"w": (100, 300), "b": (40,)}


def _plans():
    rplan = rbk.make_plan({k: jax.ShapeDtypeStruct(s, jnp.float32)
                           for k, s in SHAPES.items()},
                          cols=256, dense_below=512)
    plan = bk.make_plan({k: torch.empty(s, device="meta")
                         for k, s in SHAPES.items()},
                        cols=256, dense_below=512)
    return rplan, plan


def _plan_and_spec(workers: int = 2):
    _, plan = _plans()
    cfg = SyncConfig(ratio=0.05, bucketed=True, bucket_cols=256)
    return plan, ds.make_delta_spec(plan, cfg, workers=workers)


def _ref_spec(workers: int = 2):
    rplan, _ = _plans()
    cfg = RSyncConfig(ratio=0.05, bucketed=True, bucket_cols=256)
    return rplan, rds.make_delta_spec(rplan, cfg, workers=workers)


def _update_bufs(plan, dspec, seed):
    """Per-bucket float32 update buffers (numpy) with support <= each
    wire's k."""
    rng = np.random.default_rng(seed)
    out = []
    for spec, w in zip(plan.buckets, dspec.wires):
        g = rng.standard_normal(spec.shape).astype(np.float32)
        if spec.kind == "dense":
            out.append(g * np.float32(0.01))
            continue
        keep = np.argsort(-np.abs(g), axis=1, kind="stable")[:, :w.k]
        buf = np.zeros(spec.shape, np.float32)
        np.put_along_axis(buf, keep, np.take_along_axis(g, keep, 1), 1)
        out.append(buf)
    return out


def _init_params():
    rng = np.random.default_rng(99)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in SHAPES.items()}


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _bitwise(a, b) -> bool:
    return all(np.array_equal(_bytes(x), _bytes(y))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _run_stream(hub, plan, dspec, trainer, steps, *, start=0, on_step=None):
    """Publish ``steps`` synthetic updates, applying each to ``trainer``
    as the train step does (p - u, in place). Returns the trainer."""
    for t in range(start, start + steps):
        bufs = [torch.from_numpy(b) for b in _update_bufs(plan, dspec, t)]
        hub.publish(t, ds.encode_delta_bufs(dspec, bufs))
        for p, u in zip(tree_leaves(trainer),
                        tree_leaves(bk.unpack(plan, bufs))):
            p.sub_(u.to(p.dtype))
        if on_step is not None:
            on_step(t)
    return trainer


# -- replay catch-up (invariant 5) --------------------------------------------


@pytest.mark.parametrize("join_step", [12, 0, 9, 4, 11])
def test_replay_catchup(join_step):
    """A replica joining at any step and syncing after every later
    publish ends bit for bit the trainer's; a join past the log bound
    resyncs from a snapshot first, one inside it replays only."""
    T, log_bound = 12, 5
    plan, dspec = _plan_and_spec()
    trainer = _init_params()
    hub = FanoutHub(dspec, trainer, log_bound=log_bound)
    trainer = _run_stream(hub, plan, dspec, trainer, join_step)
    replica = hub.join()
    hub.sync(replica)
    assert replica.resyncs == (1 if join_step > log_bound else 0)
    assert _bitwise(trainer, replica.params)
    trainer = _run_stream(hub, plan, dspec, trainer, T - join_step,
                          start=join_step, on_step=lambda t: hub.sync(replica))
    assert replica.cursor == T
    assert _bitwise(trainer, replica.params)
    assert _bitwise(trainer, hub.shadow)
    if join_step < T:
        assert replica.steps_replayed >= T - join_step


def test_lagged_replica_snapshot_resync_and_replay_tail():
    plan, dspec = _plan_and_spec()
    trainer = _init_params()
    hub = FanoutHub(dspec, trainer, log_bound=6, snapshot_every=4)
    replica = hub.join()
    trainer = _run_stream(hub, plan, dspec, trainer, 15)
    hub.sync(replica)
    assert replica.resyncs == 1
    assert 0 < replica.steps_replayed <= 6  # only the post-snapshot tail
    assert _bitwise(trainer, replica.params)
    assert replica.bytes_rx < 15 * dspec.nbytes


def test_publish_out_of_order_rejected():
    plan, dspec = _plan_and_spec()
    hub = FanoutHub(dspec, _init_params(), log_bound=4)
    bufs = [torch.from_numpy(b) for b in _update_bufs(plan, dspec, 0)]
    hub.publish(0, ds.encode_delta_bufs(dspec, bufs))
    with pytest.raises(ValueError):
        hub.publish(2, ds.encode_delta_bufs(dspec, bufs))
    with pytest.raises(ValueError):
        FanoutHub(dspec, _init_params(), log_bound=4, snapshot_every=9)
    with pytest.raises(ValueError):
        hub.join("float16")


def test_bf16_tier_drift_bounded_over_10_steps():
    T = 10
    plan, dspec = _plan_and_spec()
    trainer = _init_params()
    hub = FanoutHub(dspec, trainer, log_bound=T)
    exact = hub.join()
    lossy = hub.join("bfloat16")
    trainer = _run_stream(hub, plan, dspec, trainer, T, on_step=lambda t: (
        hub.sync(exact), hub.sync(lossy)))
    assert _bitwise(trainer, exact.params)
    bound = hub.drift_bound("bfloat16")
    drift = max(float(torch.max(torch.abs(a - b)))
                for a, b in zip(tree_leaves(trainer),
                                tree_leaves(lossy.params)))
    assert 0 < drift <= bound * 1.01 + 1e-6, (drift, bound)
    assert lossy.bytes_rx < exact.bytes_rx < T * dspec.dense_nbytes


def test_transcode_delta_matches_direct_bf16_encode():
    plan, dspec = _plan_and_spec()
    bufs = [torch.from_numpy(b) for b in _update_bufs(plan, dspec, 5)]
    via = ds.transcode_delta(dspec, ds.encode_delta_bufs(dspec, bufs))
    direct = ds.encode_delta_bufs(dspec.with_value_dtype("bfloat16"), bufs)
    for a, b in zip(via, direct):
        assert torch.equal(a, b)


def _words(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32).numpy().view(np.uint32)
    return np.asarray(x).view(np.uint32)


def test_hub_on_the_reference_s_messages_matches_the_reference_hub():
    """Both hubs fed the reference's encoded messages: a steady float32
    replica, a bf16 one, a mid joiner and a late joiner (snapshot resync)
    end bit for bit equal across the packages, with the same bytes, the
    same snapshot records and the same drift bound."""
    rplan, rspec = _ref_spec()
    plan, dspec = _plan_and_spec()
    base = _init_params()
    rbase = {k: jnp.asarray(v.numpy().copy()) for k, v in base.items()}
    hubs = [RFanoutHub(rspec, rbase, log_bound=3, snapshot_every=2),
            FanoutHub(dspec, base, log_bound=3, snapshot_every=2)]
    reps = [[h.join(), h.join("bfloat16")] for h in hubs]
    for t in range(5):
        msgs = rds.encode_delta_bufs(
            rspec, [jnp.asarray(b) for b in _update_bufs(plan, dspec, t)])
        for h, rs in zip(hubs, reps):
            h.publish(t, msgs)
            for r in rs:
                h.sync(r)
            if t == 2:
                rs.append(h.join())  # cursor 0 < log start: snapshot
                h.sync(rs[-1])
    for h, rs in zip(hubs, reps):
        rs.append(h.join())
        h.sync(rs[-1])
    for r_ref, r in zip(*reps):
        assert r.tier == r_ref.tier and r.resyncs == r_ref.resyncs
        assert r.bytes_rx == r_ref.bytes_rx
        assert _bitwise(r.params, r_ref.params)
    assert _bitwise(hubs[1].shadow, hubs[0].shadow)
    assert hubs[1].stats() == hubs[0].stats()
    step_r, recs_r, n_r = hubs[0].snapshot()
    step_p, recs_p, n_p = hubs[1].snapshot()
    assert (step_p, n_p) == (step_r, n_r)
    for a, b in zip(recs_p, recs_r):
        np.testing.assert_array_equal(_words(a.buf), _words(b.buf))
    assert hubs[1].drift_bound() == pytest.approx(hubs[0].drift_bound(),
                                                  rel=1e-6)


# -- snapshot records ---------------------------------------------------------


def _record_fields(rec):
    s = rec.spec
    return (s.rows, s.cols, s.k, s.value_dtype, s.kind, rec.vs_base,
            rec.exact, rec.nbytes, rec.dense_nbytes)


def _same_record(got, want):
    assert _record_fields(got) == _record_fields(want)
    np.testing.assert_array_equal(_words(got.buf), _words(want.buf))
    assert abs(got.dropped_frac - want.dropped_frac) <= 1e-6


@pytest.mark.parametrize("support", [3, 256, 0, 1, 100])
def test_snapshot_diff_roundtrip_bitwise(support):
    rng = np.random.default_rng(1)
    base = rng.standard_normal((8, 256)).astype(np.float32)
    cur = base.copy()
    cur[:, :support] += 1.0
    rec = enc.snapshot_encode(torch.from_numpy(cur),
                              base=torch.from_numpy(base))
    _same_record(rec, renc.snapshot_encode(jnp.asarray(cur),
                                           base=jnp.asarray(base)))
    assert rec.exact
    out = enc.snapshot_decode(rec, base=torch.from_numpy(base))
    np.testing.assert_array_equal(out.numpy().view(np.uint8),
                                  cur.view(np.uint8))
    assert rec.nbytes == rec.buf.numel() * 4
    if 0 < support <= 100:
        assert rec.nbytes < rec.dense_nbytes
    if support == 256:
        assert rec.spec.kind == "dense"


def test_snapshot_diff_sees_signed_zero():
    base = np.zeros((2, 8), np.float32)
    cur = base.copy()
    cur[0, 3] = -0.0
    for b in (base, None):
        rec = enc.snapshot_encode(
            torch.from_numpy(cur),
            base=None if b is None else torch.from_numpy(b))
        _same_record(rec, renc.snapshot_encode(
            jnp.asarray(cur), base=None if b is None else jnp.asarray(b)))
        assert rec.exact
        out = enc.snapshot_decode(
            rec, base=None if b is None else torch.from_numpy(b))
        np.testing.assert_array_equal(out.numpy().view(np.uint8),
                                      cur.view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snapshot_lossy_topk_support_exact(dtype):
    m = np.random.default_rng(2).standard_normal((16, 256)).astype(np.float32)
    m[3, :40] = 0.5  # ties: the lowest indices win, as jax.lax.top_k's
    rm = jnp.asarray(m).astype(dtype)
    pm = torch.from_numpy(m).to(getattr(torch, dtype))
    rec = enc.snapshot_encode(pm, k=16)
    _same_record(rec, renc.snapshot_encode(rm, k=16))
    assert not rec.exact and 0.0 < rec.dropped_frac < 1.0
    out = enc.snapshot_decode(rec).float().numpy()
    assert (np.count_nonzero(out, axis=1) <= 16).all()
    kept = out != 0
    np.testing.assert_array_equal(pm.float().numpy()[kept], out[kept])
    assert rec.nbytes < rec.dense_nbytes / 4
    z = enc.snapshot_encode(torch.zeros((16, 256)), k=16)
    assert z.exact and z.spec.k == 1


def test_snapshot_indices_in_row_chunks_match_one_pass(monkeypatch):
    """The support scan in row chunks gives the one-pass result (the
    reference's stable argsort), on irregular supports."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((40, 96)).astype(np.float32)
    cur = base.copy()
    mask = rng.random(base.shape) < 0.1
    cur[mask] = -cur[mask]
    want = renc.snapshot_encode(jnp.asarray(cur), base=jnp.asarray(base))
    for chunk in (96, 300, 1 << 24):
        monkeypatch.setattr(enc, "SNAPSHOT_CHUNK", chunk)
        got = enc.snapshot_encode(torch.from_numpy(cur),
                                  base=torch.from_numpy(base))
        _same_record(got, want)


# -- wire checkpoints (invariant 6) -------------------------------------------


def _memory(plan, W=2):
    rng = np.random.default_rng(7)
    return tuple((rng.standard_normal((W,) + s.shape) * 0.01).astype(
        np.float32) for s in plan.buckets)


def test_checkpointer_wire_roundtrip_and_size():
    plan, dspec = _plan_and_spec()
    base = _init_params()
    trainer = _init_params()
    hub = FanoutHub(dspec, trainer, log_bound=8)
    trainer = _run_stream(hub, plan, dspec, trainer, 6)
    memory = tuple(torch.from_numpy(m) for m in _memory(plan))
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, max_to_keep=2)
        path = ck.save_wire(6, trainer, memory, plan, base_params=base,
                            memory_ratio=0.1)
        params2, mem2, meta = ck.restore_wire(plan=plan, base_params=base)
        assert _bitwise(trainer, params2)
        w = meta["wire"]
        assert w["nbytes"] * 3 < w["dense_nbytes"]
        data = np.load(path)
        assert w["nbytes"] == sum(data[k].size * 4 for k in data.files)
        for m, m2 in zip(memory, mem2):
            assert m.shape == m2.shape
            kept = m2.numpy() != 0
            np.testing.assert_array_equal(m.numpy()[kept], m2.numpy()[kept])
        with pytest.raises(ValueError):
            ck.restore_wire(plan=plan, device="cpu")
        ck.save_wire(7, trainer, memory, plan, memory_ratio=0.1)
        params3, _, meta3 = ck.restore_wire(7, plan=plan, device="cpu")
        assert _bitwise(trainer, params3)
        assert meta3["wire"]["nbytes"] > meta["wire"]["nbytes"]
        ck.save_wire(8, trainer, memory, plan, memory_ratio=0.1)
        assert ck.wire_steps() == [7, 8]


def test_wire_checkpoints_cross_between_the_packages():
    """The port reads the reference's wire checkpoint bit for bit and the
    reference reads the port's; the sidecars' sizes agree."""
    rplan, _ = _ref_spec()
    plan, dspec = _plan_and_spec()
    base = _init_params()
    trainer = _run_stream(FanoutHub(dspec, base, log_bound=8), plan, dspec,
                          _init_params(), 5)
    mem_np = _memory(plan)
    np_tree = lambda t: {k: v.numpy().copy() for k, v in t.items()}  # noqa
    with tempfile.TemporaryDirectory() as d:
        rck, ck = RCheckpointer(d + "/ref"), Checkpointer(d + "/port")
        rck.save_wire(5, {k: jnp.asarray(v) for k, v in np_tree(trainer)
                          .items()},
                      tuple(jnp.asarray(m) for m in mem_np), rplan,
                      base_params={k: jnp.asarray(v) for k, v in
                                   np_tree(base).items()},
                      memory_ratio=0.1)
        ck.save_wire(5, trainer, tuple(torch.from_numpy(m) for m in mem_np),
                     plan, base_params=base, memory_ratio=0.1)
        for name in ("step_00000005.wire.npz",):
            a, b = np.load(f"{d}/ref/{name}"), np.load(f"{d}/port/{name}")
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
            with open(f"{d}/ref/{name}.json") as f:
                ra = json.load(f)["wire"]
            with open(f"{d}/port/{name}.json") as f:
                pa = json.load(f)["wire"]
            for key in ("nbytes", "dense_nbytes", "ratio_vs_dense",
                        "has_base", "memory_ratio"):
                assert pa[key] == ra[key]
            for x, y in zip(pa["records"], ra["records"]):
                dx, dy = x.pop("dropped_frac"), y.pop("dropped_frac")
                assert x == y and abs(dx - dy) <= 1e-6
        # the port reads the reference's, and the reference the port's
        params, mem, _ = Checkpointer(d + "/ref").restore_wire(
            plan=plan, base_params=base)
        assert _bitwise(params, trainer)
        rparams, rmem, _ = RCheckpointer(d + "/port").restore_wire(
            plan=rplan, base_params={k: jnp.asarray(v)
                                     for k, v in np_tree(base).items()})
        assert _bitwise(rparams, trainer)
        for a, b in zip(mem, rmem):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dense_checkpoint_roundtrips_bf16_leaves():
    """A bf16 leaf is stored as its uint16 bits with its dtype in the
    sidecar, and comes back bit for bit; float32 and int leaves too."""
    rng = np.random.default_rng(4)
    tree = {"a": torch.from_numpy(rng.standard_normal((3, 5)).astype(
        np.float32)).to(torch.bfloat16),
            "blocks": [{"w": torch.from_numpy(rng.standard_normal(4).astype(
                np.float32))}, {"w": torch.arange(3, dtype=torch.int32)}]}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        path = ck.save(3, tree, metadata={"note": "x"})
        assert np.load(path)["a"].dtype == np.uint16
        got, meta = ck.restore(like=tree)
        assert meta["note"] == "x" and meta["dtypes"] == {"a": "bfloat16"}
        assert _bitwise(got, tree)
        assert all(a.dtype == b.dtype for a, b in zip(tree_leaves(got),
                                                      tree_leaves(tree)))
        flat, _ = ck.restore(device="cpu")
        assert flat["a"].dtype == torch.bfloat16
        assert torch.equal(flat["blocks"]["1"]["w"], tree["blocks"][1]["w"])
        with pytest.raises(ValueError, match="mismatch"):
            ck.restore(like={"a": tree["a"]})


# -- replica_copy at the serve boundary (invariant 7) -------------------------


def test_replica_copy_survives_the_in_place_step():
    """The port's train step updates params in place: a ``replica_copy``
    stays bit for bit the pre-step params, a plain reference follows."""
    cfg = get_smoke_config("rwkv6-3b")
    model = build_model(cfg)
    tc = TrainConfig(optimizer="memsgd", eta=0.5,
                     sync=SyncConfig(ratio=0.02, bucketed=True))
    params, memory, opt, count = init_train_state(model, tc, device="cpu",
                                                  seed=0)
    replica = replica_copy(params)
    alias = tree_map(lambda t: t, params)
    before = [t.clone() for t in tree_leaves(params)]
    step = make_train_step(model, tc)
    batch = next(iter(DeviceBatcher(token_batches(cfg.vocab_size, 4, 32,
                                                  seed=0), "cpu")))
    params, memory, opt, count, _ = step(params, memory, opt, count, batch)
    assert _bitwise(replica, before)
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(tree_leaves(replica), tree_leaves(params)))
    assert not _bitwise(params, replica)
    assert _bitwise(alias, params)  # what a reference held would see
