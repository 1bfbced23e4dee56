"""The port's trainer -> replica delta stream
(``repro_torch.launch.delta_stream``, ``launch.train``'s ``emit_deltas``)
against ``repro.launch.delta_stream`` on the CPU.

Held exactly: the delta specs field for field and their bytes (host
only), the wire bytes of ``encode_delta_bufs`` and ``transcode_delta`` on
the same update buffers (numpy draws from a seed: sparse rows with ties,
signed zeros and empty rows), ``decode_delta`` and ``apply_delta`` (bit
for bit the reference's on the same messages and params), and invariant
4: a replica fed by ``apply_delta`` stays bit for bit the trainer's
params through the port's bucketed steps, on the flat step and on a
``qsparse_local`` run's sync steps, its messages decoding in the
reference to the same params.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core import buckets as rbk
from repro.core.distributed import SyncConfig as RSyncConfig
from repro.launch import delta_stream as rds
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import buckets as bk
from repro_torch.core.distributed import SyncConfig, bucketed_sync_gradients
from repro_torch.data import DeviceBatcher, token_batches
from repro_torch.launch import delta_stream as ds
from repro_torch.launch.serve import replica_copy
from repro_torch.launch.train import (TrainConfig, init_train_state,
                                      make_train_step, train)
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_leaves

FIELDS = ("rows", "cols", "k", "value_dtype", "kind")


def _plans(arch="rwkv6-3b", full=False, n_layers=None):
    rcfg = (ref_get_config if full else ref_get_smoke_config)(arch)
    pcfg = (get_config if full else get_smoke_config)(arch)
    if n_layers:
        rcfg, pcfg = (c.replace(n_layers=n_layers) for c in (rcfg, pcfg))
    rplan = rbk.make_plan(ref_build_model(rcfg).param_shapes())
    plan = bk.make_plan(build_model(pcfg).param_shapes())
    return rplan, plan


# (label, sync kwargs, pod kwargs, workers, n_pods)
SPECS = [
    ("flat", dict(ratio=0.02), None, 4, 1),
    ("hierarchical static", dict(ratio=0.02, strategy="hierarchical"),
     dict(axis="pod", ratio=0.01), 8, 2),
    ("pod_dynamic", dict(ratio=0.02, strategy="hierarchical"),
     dict(axis="pod", dynamic=True), 8, 2),
]


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,kw,pod,workers,n_pods", SPECS,
                         ids=[s[0] for s in SPECS])
def test_make_delta_spec_matches_reference(label, kw, pod, workers, n_pods,
                                           value_dtype):
    """Field for field, and nbytes / dense_nbytes, at the smoke size and
    at qwen3-4b's full width (4 layers; host only)."""
    for rplan, plan in (_plans(), _plans("qwen3-4b", full=True, n_layers=4)):
        rcfg = RSyncConfig(bucketed=True, **kw)
        cfg = SyncConfig(bucketed=True, **kw)
        if pod is not None:
            rcfg, cfg = rcfg.with_pod(**pod), cfg.with_pod(**pod)
        want = rds.make_delta_spec(rplan, rcfg, workers, n_pods, value_dtype)
        got = ds.make_delta_spec(plan, cfg, workers, n_pods, value_dtype)
        assert [tuple(getattr(w, f) for f in FIELDS) for w in got.wires] == [
            tuple(getattr(w, f) for f in FIELDS) for w in want.wires]
        assert got.nbytes == want.nbytes
        assert got.dense_nbytes == want.dense_nbytes
        half = got.with_value_dtype("bfloat16")
        assert half.nbytes == want.with_value_dtype("bfloat16").nbytes


def test_full_width_delta_bytes():
    """qwen3-4b's (4 layers) float32 stream at k = 10, W = 1: k' = 10, the
    bytes the card's phase reports against the dense broadcast."""
    rplan, plan = _plans("qwen3-4b", full=True, n_layers=4)
    d = ds.make_delta_spec(plan, SyncConfig(ratio=0.01, bucketed=True), 1)
    want = rds.make_delta_spec(rplan, RSyncConfig(ratio=0.01, bucketed=True),
                               1)
    assert max(w.k for w in d.wires if w.kind == "sparse") == 10
    assert (d.nbytes, d.dense_nbytes) == (want.nbytes, want.dense_nbytes)
    assert d.dense_nbytes == 4_729_174_016
    print(f"qwen3-4b 4 layers delta: {d.nbytes} B a step against "
          f"{d.dense_nbytes} dense (x{d.dense_nbytes / d.nbytes:.2f})")


def _update_bufs(plan, dspec, seed):
    """Per-bucket float32 update buffers with support <= each wire's k
    (the trainer's invariant): values from a seed, with ties, -0.0 and
    empty rows among them."""
    rng = np.random.default_rng(seed)
    bufs = []
    for spec, w in zip(plan.buckets, dspec.wires):
        if w.kind == "dense":
            bufs.append((rng.standard_normal(spec.shape) * 0.01).astype(
                np.float32))
            continue
        out = np.zeros(spec.shape, np.float32)
        for r in range(spec.rows):
            n = rng.integers(0, w.k + 1)
            cols = rng.choice(spec.cols, n, replace=False)
            out[r, cols] = rng.choice([-0.5, 0.5, -0.0, 0.25, 1e-3], n) * (
                1 + (rng.random(n) < 0.5))
        bufs.append(out)
    return bufs


@pytest.fixture(scope="module")
def stream():
    rplan, plan = _plans()
    rspec = rds.make_delta_spec(rplan, RSyncConfig(ratio=0.02, bucketed=True),
                                workers=2)
    spec = ds.make_delta_spec(plan, SyncConfig(ratio=0.02, bucketed=True),
                              workers=2)
    return rplan, plan, rspec, spec, _update_bufs(plan, spec, 0)


def _words(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32).numpy().view(np.uint32)
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_encode_and_transcode_bytes_match_reference(stream, value_dtype):
    rplan, plan, rspec, spec, bufs = stream
    rspec = rspec.with_value_dtype(value_dtype)
    spec = spec.with_value_dtype(value_dtype)
    want = rds.encode_delta_bufs(rspec, [jnp.asarray(b) for b in bufs])
    got = ds.encode_delta_bufs(spec, [torch.from_numpy(b) for b in bufs])
    for g, w, wspec in zip(got, want, spec.wires):
        assert g.numel() * 4 == wspec.nbytes
        np.testing.assert_array_equal(_words(g), _words(w))
    if value_dtype == "float32":
        t_want = rds.transcode_delta(rspec, want, "bfloat16")
        t_got = ds.transcode_delta(spec, got, "bfloat16")
        for g, w in zip(t_got, t_want):
            np.testing.assert_array_equal(_words(g), _words(w))
        # the transcode is the direct bf16 encode of the same update
        direct = ds.encode_delta_bufs(spec.with_value_dtype("bfloat16"),
                                      [torch.from_numpy(b) for b in bufs])
        for g, d in zip(t_got, direct):
            assert torch.equal(g, d)


def test_encode_delta_of_a_tree_packs_first(stream):
    rplan, plan, rspec, spec, bufs = stream
    tree = bk.unpack(plan, [torch.from_numpy(b) for b in bufs])
    for a, b in zip(ds.encode_delta(spec, tree),
                    ds.encode_delta_bufs(spec, [torch.from_numpy(b)
                                                for b in bufs])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_decode_and_apply_match_reference(stream, value_dtype):
    """The decoded update and a replica's params after ``apply_delta``,
    bit for bit the reference's on the same messages (the float32 stream
    also reproduces the buffers exactly)."""
    rplan, plan, rspec, spec, bufs = stream
    rspec = rspec.with_value_dtype(value_dtype)
    spec = spec.with_value_dtype(value_dtype)
    msgs = ds.encode_delta_bufs(spec, [torch.from_numpy(b) for b in bufs])
    rmsgs = [jnp.asarray(_words(m)) for m in msgs]
    got = tree_leaves(ds.decode_delta(spec, msgs))
    want = jax.tree.leaves(rds.decode_delta(rspec, rmsgs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))
    if value_dtype == "float32":
        for g, b in zip(bk.pack(plan, ds.decode_delta(spec, msgs)), bufs):
            np.testing.assert_array_equal(g.numpy(), b + 0.0)  # -0.0 -> 0.0
    rng = np.random.default_rng(1)
    params_np = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        ref_build_model(ref_get_smoke_config("rwkv6-3b")).param_shapes())
    want = rds.apply_delta(jax.tree.map(jnp.asarray, params_np), rspec, rmsgs)
    params = jax.tree.map(torch.from_numpy, params_np)
    out = ds.apply_delta(params, spec, msgs)
    assert out is params  # in place, as the port's apply step
    for g, w in zip(tree_leaves(params), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))


def test_return_bufs_are_the_update_s_buffers():
    """``bucketed_sync_gradients(..., return_bufs=True)``: the update tree
    is views into the returned buffers."""
    model = build_model(get_smoke_config("rwkv6-3b"))
    plan = bk.make_plan(model.param_shapes())
    cfg = SyncConfig(ratio=0.02, bucketed=True)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda s: torch.from_numpy(
        rng.standard_normal(s.shape).astype(np.float32)),
        ref_build_model(ref_get_smoke_config("rwkv6-3b")).param_shapes())
    mem = bk.init_bucket_memory(plan, device="cpu")
    update, new_mem, nbytes, bufs = bucketed_sync_gradients(
        cfg, plan, mem, grads, 0.1, return_bufs=True)
    assert len(bufs) == len(plan.buckets)
    for u, b in zip(tree_leaves(update), tree_leaves(bk.unpack(plan, bufs))):
        assert u.data_ptr() == b.data_ptr() and torch.equal(u, b)


def _trainer(sync, delta_value_dtype="float32"):
    cfg = get_smoke_config("rwkv6-3b")
    model = build_model(cfg)
    tc = TrainConfig(optimizer="memsgd", eta=0.5, emit_deltas=True,
                     delta_value_dtype=delta_value_dtype, sync=sync)
    state = init_train_state(model, tc, device="cpu", seed=0)
    batches = iter(DeviceBatcher(token_batches(cfg.vocab_size, 4, 32, seed=1),
                                 "cpu"))
    return model, tc, make_train_step(model, tc), state, batches


def _bits_equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_replica_tracks_the_flat_trainer_bitwise():
    """Invariant 4 on the flat bucketed step (packed wire), 3 steps: the
    port's replica, and the reference's ``apply_delta`` of the port's
    messages, are bit for bit the trainer's params after every step."""
    sync = SyncConfig.preset("topk", ratio=0.02)
    model, tc, step, (params, memory, opt, count), batches = _trainer(sync)
    dspec = step.delta_spec
    rplan, _ = _plans()
    rspec = rds.make_delta_spec(rplan, RSyncConfig.preset("topk",
                                                          ratio=0.02), 1)
    replica = replica_copy(params)
    ref_replica = jax.tree.map(lambda t: jnp.asarray(t.numpy().copy()),
                               params)
    for _ in range(3):
        params, memory, opt, count, m, delta = step(params, memory, opt,
                                                    count, next(batches))
        assert sum(d.numel() * 4 for d in delta) == dspec.nbytes
        replica = ds.apply_delta(replica, dspec, delta)
        assert _bits_equal(replica, params)
        ref_replica = rds.apply_delta(ref_replica, rspec,
                                      [jnp.asarray(_words(d)) for d in delta])
        for r, p in zip(jax.tree.leaves(ref_replica), tree_leaves(params)):
            np.testing.assert_array_equal(np.asarray(r).view(np.uint32),
                                          p.numpy().view(np.uint32))


def test_bf16_delta_stream_is_the_transcoded_float32_stream():
    """``TrainConfig.delta_value_dtype="bfloat16"``: the step's spec is the
    reference's at bf16, the training is the float32 stream's bit for bit,
    and each step's messages are the float32 messages transcoded."""
    sync = SyncConfig.preset("topk", ratio=0.02)
    _, _, step32, state32, batches32 = _trainer(sync)
    _, _, step16, state16, batches16 = _trainer(sync, "bfloat16")
    rplan, _ = _plans()
    rspec = rds.make_delta_spec(rplan, RSyncConfig.preset("topk", ratio=0.02),
                                1, value_dtype="bfloat16")
    assert {w.value_dtype for w in step16.delta_spec.wires} == {"bfloat16"}
    assert step16.delta_spec.nbytes == rspec.nbytes
    assert step16.delta_spec.nbytes < step32.delta_spec.nbytes
    for _ in range(2):
        *state32, _, d32 = step32(*state32, next(batches32))
        *state16, _, d16 = step16(*state16, next(batches16))
        assert _bits_equal(state16[0], state32[0])
        for g, w in zip(d16, ds.transcode_delta(step32.delta_spec, d32)):
            assert torch.equal(g, w)


def test_replica_tracks_qsparse_local_sync_steps_bitwise():
    """Invariant 4 on the qsparse_local preset (H = 4, s = 15): the sink
    sees the sync steps only (3 and 7 of 8), and a replica fed their
    messages is bit for bit the trainer's params after each."""
    cfg = get_smoke_config("rwkv6-3b")
    model = build_model(cfg)
    tc = TrainConfig(optimizer="memsgd", eta=0.5, emit_deltas=True,
                     sync=SyncConfig.preset("qsparse_local", ratio=0.05))
    boot = model.init(seed=0, device="cpu")
    replica = replica_copy(boot)
    step = make_train_step(model, tc)
    seen = []

    def sink(i, msgs):
        seen.append(i)
        ds.apply_delta(replica, step.delta_spec, msgs)

    params, *_ = train(model, tc, DeviceBatcher(
        token_batches(cfg.vocab_size, 4, 32, seed=1), "cpu"), 8,
        device="cpu", params=boot, log_every=0, delta_sink=sink)
    assert seen == [3, 7]
    assert _bits_equal(replica, params)
    assert not _bits_equal(replica, model.init(seed=0, device="cpu"))


def test_emit_deltas_needs_the_bucketed_memsgd_path():
    model = build_model(get_smoke_config("rwkv6-3b"))
    for tc in (TrainConfig(emit_deltas=True, sync=SyncConfig(ratio=0.02)),
               TrainConfig(emit_deltas=True, optimizer="memsgd_momentum",
                           sync=SyncConfig(ratio=0.02, bucketed=True))):
        with pytest.raises(ValueError, match="emit_deltas"):
            make_train_step(model, tc)
    with pytest.raises(ValueError, match="ckpt_wire"):
        train(model, TrainConfig(sync=SyncConfig(ratio=0.02)), iter(()), 1,
              device="cpu", ckpt_wire=True)


def test_cli_prints_the_reference_s_wire_checkpoint_and_delta_lines(
        tmp_path, capsys):
    """``--emit-deltas --ckpt-wire --ckpt-dir`` on rwkv6-3b, 6 steps: the
    two lines the reference's CLI prints for the same flags (one CPU
    thread: the bytes of the params records depend on the selections)."""
    from repro_torch.launch.train import main

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        main(["--platform", "cpu", "--arch", "rwkv6-3b", "--steps", "6",
              "--batch", "4", "--seq", "64", "--emit-deltas", "--ckpt-wire",
              "--ckpt-dir", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    lines = capsys.readouterr().out.splitlines()
    # python -m repro.launch.train --arch rwkv6-3b --steps 6 --batch 4
    #     --seq 64 --emit-deltas --ckpt-wire --ckpt-dir DIR
    assert lines[-2:] == [
        "wire checkpoint: 1.04 MB (dense f32 dump: 12.87 MB, x12.4 smaller)",
        "delta stream: 1.37 MB over 6 steps (dense refresh would be 38.60 MB)",
    ]
    rplan, _ = _plans()
    rspec = rds.make_delta_spec(rplan, RSyncConfig(ratio=0.01, bucketed=True),
                                1)
    assert f"{6 * rspec.nbytes / 1e6:.2f} MB over 6" in lines[-1]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003.wire.npz", "step_00000003.wire.npz.json",
        "step_00000006.wire.npz", "step_00000006.wire.npz.json"]
