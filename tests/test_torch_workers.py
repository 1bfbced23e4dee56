"""The port's sync over two workers (a 2-rank gloo group on the CPU)
against the reference's at W = 2, which runs in-process under
``jax.vmap(..., axis_name="data")``.

The two gloo processes start once for this file (the ``runs`` fixture):
each rank runs both sync paths x both wires x float32/bf16 wire values on
its own inputs (made with numpy from a seed and the rank), at overlap
None, False and True, then a 2-rank ``main(["--preset", "topk",
"--platform", "cpu", ...])`` on the smoke config at ``--overlap`` auto,
on and off, and saves what it got. The tests compare:

* the update's support exactly, update and memory within 1e-6 (the
  reference's FMA allowance on ``m + eta*g``), bytes equal;
* packed == unpacked bit for bit, and the two ranks' updates bit for bit;
* the CLI's step-0 loss (the mean of the ranks' half-batch losses)
  against the reference's full-batch loss within rtol 1e-5 (the
  tolerance of ``test_torch_train.py``, float32 compute), and params
  bit-identical across the ranks after the run;
* the bucket pipeline: every case at ``overlap`` False and True bit for
  bit overlap None's (update, memory, bytes); the overlap=True sync on
  the packed wire against the reference's traced at overlap=True under
  the same vmap; the CLI at ``--overlap on`` and ``off`` with the losses
  and params of ``--overlap auto``;
* the quantized flat sync (``WireConfig.quant`` 15, bucketed, both
  wires): on the reference's uniforms (``_ref_quant_noise.RefNoise``)
  against the reference's ``quant_key`` sync under the same vmap, bit for
  bit on dyadic values (j/8, eta 1/2: u, the sums of squares and the
  two-term mean are exact) and within 1e-6 on random ones; on the port's
  own ``QuantNoise`` mean_w(u) == update + mean_w(m') within 1e-5,
  packed == unpacked and the two ranks' updates bit for bit, the bytes
  the quant-aware accounting; a 2-rank ``main(["--preset",
  "qsparse_local", ...])`` (8 steps: two syncs) with the same losses and
  params on both ranks and its step-0 loss the full-batch reference's;
* the delta stream (invariant 4): 3 bucketed steps with ``emit_deltas``,
  each rank's replica fed through ``apply_delta`` bit for bit its params,
  the ranks' messages identical.
"""
import itertools
import os

from _ref_quant_noise import RefNoise

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core import buckets as rbk
from repro.core.distributed import SyncConfig as RefSyncConfig
from repro.core.distributed import bucketed_message_bytes as ref_bucket_bytes
from repro.core.distributed import bucketed_sync_gradients as ref_bucketed
from repro.core.distributed import message_bytes as ref_leaf_bytes
from repro.core.distributed import sparse_sync_gradients as ref_leaf
from repro.models import build_model as ref_build_model
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.utils.tree import tree_leaves

W = 2
ETA = 0.3
COLS = 512
COL_AXES = {"w1": 0, "w2": 1, "blk": {"z": 1, "v": None}, "b": None,
            "s": None}
CASES = [(path, wire, vd) for path in ("bucketed", "per-leaf")
         for wire in ("unpacked", "packed")
         for vd in ("float32", "bfloat16")]
# every case also runs at SyncConfig.overlap False and True (the bucket
# pipeline's depth 1 and 2); None is the key without an overlap
OVERLAPS = (None, False, True)
MAIN_ARGS = ["--preset", "topk", "--platform", "cpu", "--steps", "2",
             "--batch", "4", "--seq", "32"]
# the quantized flat sync: both wires, dyadic or random values, the
# reference's uniforms or the port's own QuantNoise
QUANT = 15
QSEED, QSTEP = 4, 7
QUANT_CASES = [(wire, data, noise) for wire in ("unpacked", "packed")
               for data in ("dyadic", "random") for noise in ("ref", "own")]
QSPARSE_ARGS = ["--preset", "qsparse_local", "--platform", "cpu", "--steps",
                "8", "--batch", "4", "--seq", "32", "--ratio", "0.02"]


def _tree_np(seed):
    rng = np.random.default_rng(seed)

    def f32(*s):
        return rng.standard_normal(s).astype(np.float32)

    return {"w1": f32(128, 256), "w2": f32(3, 64, 100),
            "blk": {"z": f32(90, 200), "v": f32(60, 300)},
            "b": f32(64), "s": f32(8, 16)}


def _inputs(path, rank):
    """This rank's (memory, grads) as numpy: a tree, or for the bucketed
    path the plan's memory buffers and a tree."""
    grads = _tree_np(10 + rank)
    if path == "per-leaf":
        return _tree_np(20 + rank), grads
    from repro_torch.core import buckets as bk

    plan = bk.make_plan(params_from_jax(grads), cols=COLS)
    rng = np.random.default_rng(30 + rank)
    return [rng.standard_normal(s.shape).astype(np.float32)
            for s in plan.buckets], grads


def _quant_inputs(rank, data):
    """This rank's bucketed (memory, grads) for the quantized sync, numpy;
    dyadic: each value rounded to j/8, |j| <= 64."""
    mem, grads = _inputs("bucketed", rank)
    if data == "dyadic":
        def dy(x):
            return (np.clip(np.round(x * 8), -64, 64) / 8).astype(np.float32)

        mem = [dy(m) for m in mem]
        grads = jax.tree.map(dy, grads)
    return mem, grads


def _quant_eta(data):
    return 0.5 if data == "dyadic" else ETA


def _qcfg(wire):
    from repro_torch.core.distributed import SyncConfig, WireConfig

    return SyncConfig(ratio=0.02, bucketed=True, bucket_cols=COLS,
                      wire=WireConfig(wire=wire, quant=QUANT))


def _cfg(path, wire, vd, overlap=None):
    from repro_torch.core.distributed import SyncConfig

    return SyncConfig(ratio=0.02, bucketed=path == "bucketed",
                      bucket_cols=COLS, wire=wire, value_dtype=vd,
                      overlap=overlap)


def _worker(rank, tmp):
    """One gloo rank: every sync case, then the CLI; saves its results."""
    import io
    from contextlib import redirect_stdout

    import torch.distributed as dist

    import repro_torch.configs as configs
    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import (bucketed_sync_gradients,
                                              sparse_sync_gradients)
    from repro_torch.launch import train as train_mod

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=W)
    out = {}
    try:
        for (path, wire, vd), overlap in itertools.product(CASES, OVERLAPS):
            mem_np, grads_np = _inputs(path, rank)
            grads = params_from_jax(grads_np)
            cfg = _cfg(path, wire, vd, overlap)
            if path == "bucketed":
                plan = bk.make_plan(grads, cols=COLS)
                upd, mem, nbytes = bucketed_sync_gradients(
                    cfg, plan, [torch.from_numpy(m) for m in mem_np], grads,
                    ETA)
                mem = list(mem)
            else:
                upd, mem, nbytes = sparse_sync_gradients(
                    cfg, params_from_jax(mem_np), grads, ETA, COL_AXES)
                mem = tree_leaves(mem)
            key = (path, wire, vd) + ((overlap,) if overlap is not None
                                      else ())
            out[key] = (tree_leaves(upd), mem, nbytes)
        from repro_torch.optim.qsgd import QuantNoise

        for wire, data, noise in QUANT_CASES:
            mem_np, grads_np = _quant_inputs(rank, data)
            grads = params_from_jax(grads_np)
            upd, mem, nbytes = bucketed_sync_gradients(
                _qcfg(wire), bk.make_plan(grads, cols=COLS),
                [torch.from_numpy(m) for m in mem_np], grads,
                _quant_eta(data), quant_noise=(RefNoise if noise == "ref"
                                               else QuantNoise)(QSEED, QSTEP))
            out["quant", wire, data, noise] = (tree_leaves(upd), list(mem),
                                               nbytes)
        get = configs.get_smoke_config  # float32 compute for the parity
        configs.get_smoke_config = lambda arch: get(arch).replace(
            compute_dtype="float32")
        for flag in ("auto", "on", "off"):
            text = io.StringIO()
            with redirect_stdout(text):
                params, memory, _, count, history = train_mod.main(
                    MAIN_ARGS + ["--overlap", flag])
            out["main" if flag == "auto" else ("main", flag)] = (
                tree_leaves(params), history, count, text.getvalue())
        text = io.StringIO()
        with redirect_stdout(text):
            params, memory, _, count, history = train_mod.main(QSPARSE_ARGS)
        out["qsparse main"] = (tree_leaves(params), list(memory), history,
                               count, text.getvalue())
        out["delta"] = _delta_stream_run()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _delta_stream_run():
    """This rank's 3 bucketed steps of rwkv6-3b's smoke config (float32,
    the packed wire, threshold_onehot) with ``emit_deltas``, a replica fed
    every step's messages through ``apply_delta``: (the replica bit for
    bit the params, the messages, their bytes, the spec's)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.distributed import SyncConfig, WireConfig
    from repro_torch.data import ShardedBatcher, token_batches
    from repro_torch.launch import delta_stream as ds
    from repro_torch.launch.serve import replica_copy
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step)
    from repro_torch.models import build_model

    cfg = get_smoke_config("rwkv6-3b")
    model = build_model(cfg)
    tc = TrainConfig(optimizer="memsgd", eta=0.5, emit_deltas=True,
                     sync=SyncConfig(ratio=0.02, bucketed=True,
                                     selection="threshold_onehot",
                                     wire=WireConfig(wire="packed")))
    params, memory, opt, count = init_train_state(model, tc, device="cpu",
                                                  seed=0)
    replica = replica_copy(params)
    step = make_train_step(model, tc)
    batches = iter(ShardedBatcher(token_batches(cfg.vocab_size, 8, 32,
                                                seed=1), "cpu", prefetch=0))
    msgs, nbytes = [], []
    for _ in range(3):
        params, memory, opt, count, _, delta = step(params, memory, opt,
                                                    count, next(batches))
        ds.apply_delta(replica, step.delta_spec, delta)
        msgs.append(list(delta))
        nbytes.append(sum(d.numel() * 4 for d in delta))
    exact = all(torch.equal(_bits(a), _bits(b))
                for a, b in zip(tree_leaves(replica), tree_leaves(params)))
    return exact, msgs, nbytes, step.delta_spec.nbytes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results, from one 2-process gloo run for the file."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path_factory.mktemp("gloo"))
    mp.spawn(_worker, args=(tmp,), nprocs=W, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(W)]


def _reference(path, wire, vd, overlap=None):
    """The reference's W = 2 sync under vmap over the worker axis, at
    ``overlap``: (update leaves per worker, memory leaves per worker,
    bytes)."""
    cfg = _cfg(path, wire, vd)
    rcfg = RefSyncConfig(ratio=cfg.ratio, bucketed=cfg.bucketed,
                         bucket_cols=COLS, wire=wire, value_dtype=vd,
                         overlap=overlap, _warn=False)
    mems, grads = zip(*(_inputs(path, r) for r in range(W)))
    stack = lambda *xs: jnp.stack([jnp.asarray(x) for x in xs])  # noqa
    g = jax.tree.map(stack, *grads)
    if path == "bucketed":
        plan = rbk.make_plan(jax.tree.map(jnp.asarray, grads[0]), cols=COLS)
        m = tuple(stack(*bs) for bs in zip(*mems))
        fn = lambda m, g: ref_bucketed(  # noqa: E731
            rcfg, plan, m, g, jnp.float32(ETA))[:2]
        nbytes = ref_bucket_bytes(rcfg, plan)
    else:
        m = jax.tree.map(stack, *mems)
        fn = lambda m, g: ref_leaf(  # noqa: E731
            rcfg, m, g, jnp.float32(ETA), COL_AXES)[:2]
        nbytes = ref_leaf_bytes(rcfg, grads[0], COL_AXES)
    upd, mem = jax.jit(jax.vmap(fn, axis_name="data"))(m, g)
    return ([np.asarray(x) for x in jax.tree.leaves(upd)],
            [np.asarray(x) for x in jax.tree.leaves(mem)], nbytes)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _assert_matches_reference(runs, key, ref):
    """Every rank's (update, memory, bytes) of ``key`` against the
    reference's: the update's support exactly, update and memory within
    1e-6, bytes equal."""
    r_upd, r_mem, r_nbytes = ref
    for rank in range(W):
        upd, mem, nbytes = runs[rank][key]
        assert nbytes == r_nbytes
        assert len(upd) == len(r_upd) and len(mem) == len(r_mem)
        for a, b in zip(upd, r_upd):
            a, b = a.numpy(), b[rank]
            np.testing.assert_array_equal(a != 0, b != 0)  # the support
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        for a, b in zip(mem, r_mem):
            np.testing.assert_allclose(a.numpy(), b[rank], rtol=0, atol=1e-6)


@pytest.mark.parametrize("path,wire,vd", CASES)
def test_sync_matches_reference_at_two_workers(runs, path, wire, vd):
    _assert_matches_reference(runs, (path, wire, vd),
                              _reference(path, wire, vd))


@pytest.mark.parametrize("path,wire,vd", CASES)
def test_overlap_modes_are_bitwise_equal_at_two_workers(runs, path, wire,
                                                        vd):
    """Overlap False (depth 1) and True (the double buffer, each bucket's
    gather in flight while the next selects) give overlap None's update,
    memory and bytes bit for bit, on both ranks."""
    for rank in range(W):
        upd, mem, nbytes = runs[rank][(path, wire, vd)]
        for overlap in (False, True):
            o_upd, o_mem, o_nbytes = runs[rank][(path, wire, vd, overlap)]
            assert o_nbytes == nbytes and len(o_upd + o_mem) == len(upd + mem)
            for a, b in zip(o_upd + o_mem, upd + mem):
                assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("path,vd", [(p, v) for p in ("bucketed", "per-leaf")
                                     for v in ("float32", "bfloat16")])
def test_overlap_on_matches_reference_at_two_workers(runs, path, vd):
    """The port's overlap=True sync against the reference's traced at
    overlap=True under jax.vmap (its double-buffered schedule with
    optimization barriers), on the packed wire (packed == unpacked is
    held bit for bit above)."""
    _assert_matches_reference(runs, (path, "packed", vd, True),
                              _reference(path, "packed", vd, overlap=True))


@pytest.mark.parametrize("flag", ["on", "off"])
def test_two_rank_main_overlap_gives_the_auto_losses(runs, flag):
    """``main([..., "--overlap", flag])`` on two ranks: the same losses
    as ``--overlap auto`` and the same params bit for bit."""
    p_auto, h_auto, c_auto, _ = runs[0]["main"]
    for r in runs:
        params, history, count, _ = r["main", flag]
        assert count == c_auto and history == h_auto
        for a, b in zip(params, p_auto):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("path", ["bucketed", "per-leaf"])
@pytest.mark.parametrize("vd", ["float32", "bfloat16"])
def test_packed_equals_unpacked_and_ranks_agree(runs, path, vd):
    for rank in range(W):
        p_upd, p_mem, _ = runs[rank][(path, "packed", vd)]
        u_upd, u_mem, _ = runs[rank][(path, "unpacked", vd)]
        for a, b in zip(p_upd + p_mem, u_upd + u_mem):
            assert torch.equal(_bits(a), _bits(b))
    for a, b in zip(runs[0][(path, "packed", vd)][0],
                    runs[1][(path, "packed", vd)][0]):
        assert torch.equal(_bits(a), _bits(b))  # one update on every rank


def test_two_rank_main_matches_the_full_batch_reference(runs):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import token_batches
    from repro_torch.models import build_model

    (p0, h0, c0, text0), (p1, h1, c1, text1) = (runs[r]["main"]
                                                for r in range(W))
    assert c0 == c1 == 2 and h0 == h1  # the loss is the workers' mean
    assert "step     0" in text0 and text1 == ""  # only rank 0 prints
    for a, b in zip(p0, p1):
        assert torch.equal(_bits(a), _bits(b))
    cfg = get_smoke_config("qwen3-4b").replace(compute_dtype="float32")
    params = params_to_jax(build_model(cfg).init(seed=0, device="cpu"))
    batch = next(token_batches(cfg.vocab_size, 4, 32, seed=0))
    rmodel = ref_build_model(ref_get_smoke_config("qwen3-4b").replace(
        compute_dtype="float32"))
    _, metrics = rmodel.loss(jax.tree.map(jnp.asarray, params),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(h0[0][1], float(metrics["xent"]), rtol=1e-5)


_QREF = {}


def _quant_reference(wire, data):
    """The reference's quantized flat sync at W = 2 under vmap over the
    worker axis, its quant_key fold_in(PRNGKey(QSEED), QSTEP): (update
    leaves per worker, memory buffers per worker, bytes)."""
    from repro.core.distributed import WireConfig as RefWireConfig

    if (wire, data) in _QREF:
        return _QREF[wire, data]
    rcfg = RefSyncConfig(ratio=0.02, bucketed=True, bucket_cols=COLS,
                         wire=RefWireConfig(wire=wire, quant=QUANT))
    mems, grads = zip(*(_quant_inputs(r, data) for r in range(W)))
    stack = lambda *xs: jnp.stack([jnp.asarray(x) for x in xs])  # noqa
    plan = rbk.make_plan(jax.tree.map(jnp.asarray, grads[0]), cols=COLS)
    qkey = jax.random.fold_in(jax.random.PRNGKey(QSEED), QSTEP)
    eta = jnp.float32(_quant_eta(data))

    def fn(m, g):
        return ref_bucketed(rcfg, plan, m, g, eta, quant_key=qkey)[:2]

    upd, mem = jax.jit(jax.vmap(fn, axis_name="data"))(
        tuple(stack(*bs) for bs in zip(*mems)), jax.tree.map(stack, *grads))
    _QREF[wire, data] = ([np.asarray(x) for x in jax.tree.leaves(upd)],
                         [np.asarray(x) for x in mem],
                         ref_bucket_bytes(rcfg, plan))
    return _QREF[wire, data]


@pytest.mark.parametrize("wire", ["unpacked", "packed"])
@pytest.mark.parametrize("data", ["dyadic", "random"])
def test_quantized_sync_matches_reference_at_two_workers(runs, wire, data):
    """On the reference's uniforms: dyadic values bit for bit (update and
    memory), random ones within 1e-6; the bytes equal."""
    r_upd, r_mem, r_nbytes = _quant_reference(wire, data)
    for rank in range(W):
        upd, mem, nbytes = runs[rank]["quant", wire, data, "ref"]
        assert nbytes == r_nbytes
        assert len(upd) == len(r_upd) and len(mem) == len(r_mem)
        for a, b in zip(upd + mem, r_upd + r_mem):
            a, b = a.numpy(), b[rank]
            if data == "dyadic":
                np.testing.assert_array_equal(a.view(np.uint32),
                                              b.view(np.uint32))
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("data", ["dyadic", "random"])
def test_quantized_sync_with_the_ports_noise_at_two_workers(runs, data):
    """With the port's own noise: packed == unpacked and the ranks'
    updates bit for bit, the bytes the quant-aware accounting, and mass
    conserved: mean_w(u) == update + mean_w(m') within 1e-5 (the memory
    keeps each worker's quantization error), in bucket space without the
    padding tail."""
    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import bucketed_message_bytes

    for rank in range(W):
        p = runs[rank]["quant", "packed", data, "own"]
        u = runs[rank]["quant", "unpacked", data, "own"]
        for a, b in zip(p[0] + p[1], u[0] + u[1]):
            assert torch.equal(_bits(a), _bits(b))
    for a, b in zip(runs[0]["quant", "packed", data, "own"][0],
                    runs[1]["quant", "packed", data, "own"][0]):
        assert torch.equal(_bits(a), _bits(b))
    grads0 = params_from_jax(_quant_inputs(0, data)[1])
    plan = bk.make_plan(grads0, cols=COLS)
    upd, _, nbytes = runs[0]["quant", "packed", data, "own"]
    assert nbytes == bucketed_message_bytes(_qcfg("packed"), plan)
    upd_bufs = bk.pack(plan, plan.treedef.unflatten(upd))
    eta = np.float32(_quant_eta(data))
    for b in range(len(plan.buckets)):
        us, ms = [], []
        for rank in range(W):
            m_np, g_np = _quant_inputs(rank, data)
            g = bk.pack(plan, params_from_jax(g_np))[b].numpy()
            us.append(m_np[b] + eta * g)
            ms.append(runs[rank]["quant", "packed", data, "own"][1][b]
                      .numpy())
        size = plan.buckets[b].size  # without the padding tail
        err = np.abs(np.mean(us, 0) - (upd_bufs[b].numpy()
                                       + np.mean(ms, 0))).ravel()[:size]
        assert err.max() <= 1e-5, err.max()


def test_two_rank_main_runs_the_qsparse_local_preset(runs):
    """``main`` on the qsparse_local preset at two ranks: 8 steps at H = 4
    (two syncs of the quantized packed wire), the same losses, params and
    params on both ranks, finite losses, only rank 0 printing; its step-0
    loss the reference's full-batch loss within rtol 1e-5."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import token_batches
    from repro_torch.models import build_model

    (p0, m0, h0, c0, text0), (p1, m1, h1, c1, text1) = (
        runs[r]["qsparse main"] for r in range(W))
    assert c0 == c1 == 8 and h0 == h1
    assert all(np.isfinite(x) for _, x in h0)
    assert "step     0" in text0 and text1 == ""
    for a, b in zip(p0, p1):
        assert torch.equal(_bits(a), _bits(b))
    cfg = get_smoke_config("qwen3-4b").replace(compute_dtype="float32")
    params = params_to_jax(build_model(cfg).init(seed=0, device="cpu"))
    batch = next(token_batches(cfg.vocab_size, 4, 32, seed=0))
    rmodel = ref_build_model(ref_get_smoke_config("qwen3-4b").replace(
        compute_dtype="float32"))
    _, metrics = jax.jit(rmodel.loss)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(h0[0][1], float(metrics["xent"]), rtol=1e-5)


def test_delta_stream_replica_tracks_two_workers_bitwise(runs):
    """Invariant 4 at W = 2 (``tests/test_wire_codec.py``'s delta stream
    case): each rank's replica fed the 3 steps' packed deltas is bit for
    bit its params; the two ranks emit the same bytes (the gathered update
    is one), each step ``delta_spec.nbytes``, the support bound W * k a
    row; the stream is under a quarter of a dense refresh."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import SyncConfig
    from repro_torch.launch import delta_stream as ds
    from repro_torch.models import build_model

    (e0, m0, n0, spec0), (e1, m1, n1, spec1) = (runs[r]["delta"]
                                                for r in range(W))
    assert e0 and e1
    assert n0 == n1 == [spec0] * 3 and spec0 == spec1
    for a, b in zip(m0, m1):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    plan = bk.make_plan(build_model(get_smoke_config("rwkv6-3b"))
                        .param_shapes())
    dspec = ds.make_delta_spec(plan, SyncConfig(ratio=0.02, bucketed=True),
                               workers=W)
    assert dspec.nbytes == spec0
    assert max(w.k for w in dspec.wires if w.kind == "sparse") == W * 20
    assert 3 * spec0 * 4 < 3 * dspec.dense_nbytes
