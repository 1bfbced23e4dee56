"""The port's two-level pod sync over four gloo ranks laid out (2 pods x 2
data) against the reference's, which runs in-process under nested
``jax.vmap`` over ("pod", "data") (its ``axis_size`` is a psum, so the
two-level chain traces there).

The four gloo processes start once for this file (the ``runs`` fixture).
Each rank runs every sync case on its own inputs (made with numpy from a
seed and the rank; rank = pod * 2 + data): the bucketed path with a
static ``pod_ratio``, with per-bucket ``pod_ratios`` and with the runtime
pod k (``pod_dynamic``, live ks below k_max, the repack boundary), and the
per-leaf path with a static pod k, each on both wires and at overlap
None, False and True; the bucket pipeline's self-checks on the layout
(``overlap_selfcheck`` on both wires, ``repack_selfcheck``); then three
``train()`` runs of rwkv6-3b's smoke config on the ``pod_budgeted``
preset at a byte budget, one water-filling its pod ks again every 2
steps, one replaying the first's schedule and one repeating the first
with overlap on; the pod-ratio
calibration (``PodRatioCalibrator``) at (2, 2) and (4, 1); then the
4-rank ``main([... "--pods", "2", "--strategy", "hierarchical",
...])``. The tests compare:

* the update's support exactly, update and memory within 1e-6 (the
  reference's FMA allowance on ``m + eta*g``), bytes equal, and the bytes
  each level realized equal to ``bucketed_message_bytes(by_level=True)``
  (at the live ks under the repack boundary);
* packed == unpacked bit for bit, and the four ranks' updates bit for
  bit;
* invariant 8: mean_w(u) == update + mean_w(new memory);
* invariant 9: a constant live k equal to the static k gives the static
  path's update and memory bit for bit, and a recorded refresh schedule
  replays bit for bit, within its byte budget;
* the calibration's ratios, and the water-filled run's first pod ks,
  equal to the reference's ``PodRatioCalibrator`` and allocation on the
  same global batch and memories;
* the CLI's step-0 loss (the mean of the ranks' quarter-batch losses)
  against the reference's full-batch loss within rtol 1e-5;
* invariant 10: overlap False and True give overlap None's update,
  memory and bytes bit for bit on every case, and the overlap-on refresh
  run the refresh run's params and memory; the overlap=True sync against
  the reference's traced at overlap=True; every self-check flag True,
  and the repack check's bytes the reference's accounting.

The quantized two-level sync (``WireConfig.quant`` 15; the static pod k,
and the runtime pod k through the repack boundary; both wires): on the
reference's uniforms (``_ref_quant_noise``: level 1 folds the data index,
then the pod; level 2 the pod) against the reference's ``quant_key`` sync
under the same nested vmap, the update and memory within 1e-6 plus 4e-7
of the tensor's largest |value| (the level-2 norm sums dequantized values
in XLA's order or the port's, 2 ulp apart), the bytes by level its
accounting; on the port's own ``QuantNoise`` the level-2 codes of the two
ranks of a pod identical, packed == unpacked and the four ranks' updates
bit for bit, mass conserved within 1e-5; ``local_quant_selfcheck`` on the
layout, every flag True.

At (2, 2) each cross-worker sum has two terms, so the pod means are the
reference's bits up to ``u``'s FMA.
"""
import itertools
import os
import warnings

from _ref_quant_noise import pod_noise

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

PODS, DATA = 2, 2
W = PODS * DATA
ETA = 0.3
COLS = 512
COL_AXES = {"w1": 0, "w2": 1, "blk": {"z": 1, "v": None}, "b": None,
            "s": None}
# the sync modes: the static pod k (5 of 512), per-bucket pod ratios (the
# sparse bucket at 7), the runtime pod k at a live 7 (k_max 2 * 10 = 20)
BASE = dict(ratio=0.02, bucket_cols=COLS, strategy="hierarchical",
            pod_axis="pod")
MODES = {"static": dict(pod_ratio=0.01),
         "ratios": dict(pod_ratios=(1.0, 7 / 512)),
         "dynamic": dict(pod_dynamic=True, repack=True)}
LIVE = (1, 7)
CASES = ([("bucketed", mode, wire) for mode in MODES
          for wire in ("unpacked", "packed")]
         + [("per-leaf", "static", wire) for wire in ("unpacked", "packed")])
# the same chain at bf16 wire values (the pod mean, its re-select and the
# residual in bf16): the static pod k, the runtime pod k through the
# repack boundary, and the per-leaf path, on both wires
BF16_CASES = [(path, mode, wire) for path, mode in (
    ("bucketed", "static"), ("bucketed", "dynamic"), ("per-leaf", "static"))
    for wire in ("unpacked", "packed")]
# every case also runs at SyncConfig.overlap False and True (the bucket
# pipeline's depth 1 and 2); None is the key without an overlap
OVERLAPS = (None, False, True)
# the quantized two-level sync: the static pod k and the runtime pod k
# through the repack boundary, both wires, the reference's uniforms or the
# port's own QuantNoise
QUANT = 15
QSEED, QSTEP = 4, 7
QUANT_CASES = [(mode, wire, noise) for mode in ("static", "dynamic")
               for wire in ("unpacked", "packed") for noise in ("ref", "own")]
ARCH = "rwkv6-3b"
TRAIN = dict(batch=4, seq=32, steps=5, eta=0.3)
TRAIN_RATIO = 0.02
# the calibration: PodRatioCalibrator on a global batch of CAL_BATCH
# (one sequence a rank), at (2, 2) and at (4, 1) (one worker a pod: the
# global batch's u with the mean of every worker's memory), in both sizing
# modes, at zero memory and at each rank's own memory, with k_caps as the
# refresh passes them (CAL_CAP, above the ks these inputs give). The
# memory holds CAL_SPIKES entries a row of about the largest |eta * g|
# (~0.03) at columns of its own: at (2, 2) the autotuned k is 31 without
# it, 22 with the shards' own memories and 15 with pod 0's first memory
# for both; at (4, 1) 16 with the mean of the memories and 10 with rank
# 0's alone
CAL_BATCH = dict(batch=4, seq=32, seed=9)
CAL_CAP, CAL_SPIKES, CAL_SPIKE = 36, 12, 0.03
CAL_CASES = [(layout, mode, mem) for layout in ((2, 2), (4, 1))
             for mode in ("autotune", "budget") for mem in (False, True)]
# at bf16 wire values (the shards' selections still move in float32, as
# the reference measures them; the budget's bytes are bf16 messages')
BF16_CAL_CASES = [((2, 2), "autotune", True), ((2, 2), "budget", True)]
MAIN_ARGS = ["--arch", ARCH, "--pods", "2", "--strategy", "hierarchical",
             "--bucketed", "--wire", "packed", "--pod-refresh-every", "2",
             "--platform", "cpu", "--steps", "3", "--batch", "4",
             "--seq", "32", "--eta", "0.3"]


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


def _cfg(path, mode, wire, vd="float32", overlap=None):
    from repro_torch.core.distributed import SyncConfig

    return SyncConfig(bucketed=path == "bucketed", wire=wire, **BASE,
                      **MODES[mode], value_dtype=vd, overlap=overlap)


def _qcfg(mode, wire, pkg="port"):
    """The quantized two-level config of ``mode``, the port's or the
    reference's."""
    if pkg == "port":
        from repro_torch.core.distributed import (PodConfig, SyncConfig,
                                                  TransportConfig,
                                                  WireConfig)
    else:
        from repro.core.distributed import (PodConfig, SyncConfig,
                                            TransportConfig, WireConfig)
    pod = (dict(ratio=0.01) if mode == "static" else dict(dynamic=True))
    return SyncConfig(ratio=0.02, bucket_cols=COLS, strategy="hierarchical",
                      bucketed=True, pod=PodConfig(axis="pod", **pod),
                      wire=WireConfig(wire=wire, quant=QUANT),
                      transport=TransportConfig(repack=mode == "dynamic"))


def _quant_runs(layout, rank):
    """Every QUANT_CASES sync on this rank, with the codes each quantize
    stage drew (level 1, then level 2, by bucket)."""
    import repro_torch.core.distributed as dist_mod
    from repro_torch.core import buckets as bk
    from repro_torch.optim.qsgd import QuantNoise

    out = {}
    real = dist_mod._quantize_selected
    for mode, wire, noise in QUANT_CASES:
        mem_np, grads_np = _inputs("bucketed", rank)
        grads = params_from_jax(grads_np)
        level, codes = {"intra": 0, "cross": 0}, []

        def spy(cfg, vals, uniforms):
            q = real(cfg, vals, uniforms)
            codes.append(q[1].clone())
            return q

        dist_mod._quantize_selected = spy
        try:
            upd, mem, nbytes = dist_mod.bucketed_sync_gradients(
                _qcfg(mode, wire), bk.make_plan(grads, cols=COLS),
                [torch.from_numpy(m) for m in mem_np], grads, ETA,
                layout=layout, level_bytes=level,
                pod_ks=LIVE if mode == "dynamic" else None,
                quant_noise=(pod_noise(DATA) if noise == "ref"
                             else QuantNoise)(QSEED, QSTEP))
        finally:
            dist_mod._quantize_selected = real
        out[mode, wire, noise] = (tree_leaves(upd), list(mem), nbytes, level,
                                  codes)
    return out


def _train_runs(layout):
    """rwkv6-3b's smoke config on the pod_budgeted preset at a cross-pod
    byte budget (the accounted bytes at pod k 5): a run water-filling its
    pod ks again every 2 steps, and a fresh run replaying that run's
    schedule. Returns both runs' params and memory, the schedule, and the
    budget with the cross-pod bytes of each scheduled ks."""
    import dataclasses

    from repro_torch.configs import PodRefreshConfig
    from repro_torch.core.distributed import (SyncConfig,
                                              bucketed_message_bytes)
    from repro_torch.data import ShardedBatcher, token_batches
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.utils.telemetry import Telemetry

    model = _small_model()
    plan = _small_plan(model)
    preset = SyncConfig.preset("pod_budgeted", ratio=TRAIN_RATIO)

    def cross(ks):
        return bucketed_message_bytes(
            dataclasses.replace(preset, pod_axis="pod"), plan, by_level=True,
            pod_ks=ks)["cross"]

    budget = cross([5 if s.kind == "sparse" else 1 for s in plan.buckets])
    sync = dataclasses.replace(preset, byte_budget=budget)
    out = {"budget": budget}
    for run in ("refresh", "replay", "refresh overlap"):
        # "refresh overlap": the refresh run with the bucket pipeline's
        # double buffer
        tc = TrainConfig(eta=TRAIN["eta"], sync=dataclasses.replace(
            sync, overlap=True if run == "refresh overlap" else None),
            pod_refresh=(PodRefreshConfig(every=2) if run != "replay"
                         else None))
        batches = ShardedBatcher(token_batches(
            model.cfg.vocab_size, TRAIN["batch"], TRAIN["seq"], seed=3),
            "cpu")
        tel = Telemetry(printer=lambda line: None)
        params, memory, *_ = train(
            model, tc, batches, TRAIN["steps"], device="cpu",
            telemetry=tel, layout=layout,
            pod_k_schedule=out.get("schedule") if run == "replay" else None)
        out[run] = tree_leaves(params) + list(memory)
        if run == "refresh":
            out["schedule"] = list(tel.refresh_schedule)
            out["initial"] = tel.initial_pod_ks
            out["cross"] = [cross(ks) for _, ks in out["schedule"]]
    return out


def _small_model():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    return build_model(get_smoke_config(ARCH).replace(
        compute_dtype="float32"))


def _small_plan(model):
    from repro_torch.core import buckets as bk

    return bk.make_plan(model.param_shapes(), cols=1024, dense_below=16_384)


def _cal_batch(vocab):
    from repro_torch.data import token_batches

    return next(token_batches(vocab, CAL_BATCH["batch"], CAL_BATCH["seq"],
                              seed=CAL_BATCH["seed"]))


def _cal_memory(plan, rank):
    """Rank ``rank``'s memory buffers for the calibration, numpy: noise at
    5% of CAL_SPIKE, and in each sparse row CAL_SPIKES entries of scale
    CAL_SPIKE at columns drawn for the rank."""
    rng = np.random.default_rng(60 + rank)
    out = []
    for s in plan.buckets:
        m = (0.05 * CAL_SPIKE * rng.standard_normal(s.shape)).astype(
            np.float32)
        if s.kind == "sparse":
            rows, cols = s.shape
            at = np.stack([rng.choice(cols, CAL_SPIKES, replace=False)
                           for _ in range(rows)])
            spikes = CAL_SPIKE * rng.standard_normal((rows, CAL_SPIKES))
            m[np.arange(rows)[:, None], at] += spikes.astype(np.float32)
        out.append(m)
    return out


def _cal_caps(plan, mem):
    return (tuple(CAL_CAP if s.kind == "sparse" else 1 for s in plan.buckets)
            if mem else None)


def _cal_sync(mode, budget, sync_cls, vd="float32"):
    """The calibration's sync config, the port's or the reference's
    (``sync_cls``): hierarchical on the packed wire, or the
    ``pod_budgeted`` preset at ``budget``; at ``vd`` wire values."""
    import dataclasses

    if mode == "autotune":
        return sync_cls(strategy="hierarchical", ratio=TRAIN_RATIO,
                        bucketed=True, wire="packed", pod_axis="pod",
                        value_dtype=vd)
    return dataclasses.replace(sync_cls.preset(
        "pod_budgeted", ratio=TRAIN_RATIO, value_dtype=vd), pod_axis="pod",
        byte_budget=budget)


def _calibrations(rank, budget):
    """The port's PodRatioCalibrator on every CAL_CASES case: this rank's
    sequence of the global batch, its own memory where the case has one.
    Returns {case: ratios}."""
    from repro_torch.core.distributed import SyncConfig
    from repro_torch.launch.mesh import make_layout
    from repro_torch.launch.train import PodRatioCalibrator

    model = _small_model()
    plan = _small_plan(model)
    params = model.init(seed=0, device="cpu")
    mine = {k: torch.from_numpy(v[rank:rank + 1])
            for k, v in _cal_batch(model.cfg.vocab_size).items()}
    memory = [torch.from_numpy(m) for m in _cal_memory(plan, rank)]
    layouts = {shape: make_layout(*shape) for shape in ((2, 2), (4, 1))}
    out = {}
    for shape, mode, mem, vd in ([c + ("float32",) for c in CAL_CASES]
                                 + [c + ("bfloat16",)
                                    for c in BF16_CAL_CASES]):
        calib = PodRatioCalibrator(model, plan, layouts[shape],
                                   _cal_sync(mode, budget, SyncConfig, vd))
        key = (shape, mode, mem) + ((vd,) if vd != "float32" else ())
        out[key] = calib.ratios(
            params, mine, ETA, [m.clone() for m in memory] if mem else None,
            k_caps=_cal_caps(plan, mem))
    # rank 0's measured buffers at each wire dtype: the sparse buckets'
    # simulated pod means (every rank takes part in forming them)
    for vd in ("float32", "bfloat16"):
        calib = PodRatioCalibrator(model, plan, layouts[2, 2], _cal_sync(
            "autotune", budget, SyncConfig, vd))
        bufs = calib.u_bufs(params, mine, ETA, [m.clone() for m in memory])
        if bufs is not None:
            out[vd, "pod means"] = [b for b in bufs if b is not None]
    return out


def _worker(rank, tmp):
    """One gloo rank: every sync case, the two train runs and the CLI;
    saves its results."""
    import io
    from contextlib import redirect_stdout

    import torch.distributed as dist

    import repro_torch.configs as configs
    from repro_torch.core import buckets as bk
    from repro_torch.core.distributed import (bucketed_sync_gradients,
                                              sparse_sync_gradients)
    from repro_torch.core.selfcheck import (local_quant_selfcheck,
                                            overlap_selfcheck,
                                            repack_selfcheck)
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_layout, n_chips, pod_axis_of

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=W)
    out = {}
    try:
        layout = make_layout(PODS)
        out["layout"] = (layout.pod, layout.data, n_chips(layout),
                         pod_axis_of(layout))
        for (path, mode, wire, vd), overlap in itertools.product(
                [c + ("float32",) for c in CASES]
                + [c + ("bfloat16",) for c in BF16_CASES], OVERLAPS):
            mem_np, grads_np = _inputs(path, rank)
            grads = params_from_jax(grads_np)
            cfg = _cfg(path, mode, wire, vd, overlap)
            level = {"intra": 0, "cross": 0}
            if path == "bucketed":
                plan = bk.make_plan(grads, cols=COLS)
                upd, mem, nbytes = bucketed_sync_gradients(
                    cfg, plan, [torch.from_numpy(m) for m in mem_np], grads,
                    ETA, layout=layout, level_bytes=level,
                    pod_ks=LIVE if mode == "dynamic" else None)
                mem = list(mem)
            else:
                upd, mem, nbytes = sparse_sync_gradients(
                    cfg, params_from_jax(mem_np), grads, ETA, COL_AXES,
                    layout=layout)
                mem = tree_leaves(mem)
            key = ((path, mode, wire) + ((vd,) if vd != "float32" else ())
                   + (("overlap", overlap) if overlap is not None else ()))
            out[key] = (tree_leaves(upd), mem, nbytes, level)
        out["selfchecks"] = (overlap_selfcheck(layout),
                             overlap_selfcheck(layout, wire="unpacked"),
                             repack_selfcheck(layout))
        out["quant"] = _quant_runs(layout, rank)
        out["local_quant_selfcheck"] = local_quant_selfcheck(layout)
        out["train"] = _train_runs(layout)
        out["calibration"] = _calibrations(rank, out["train"]["budget"])
        get = configs.get_smoke_config  # float32 compute for the parity
        configs.get_smoke_config = lambda arch: get(arch).replace(
            compute_dtype="float32")
        text = io.StringIO()
        with redirect_stdout(text):
            params, memory, _, count, history = train_mod.main(MAIN_ARGS)
        out["main"] = (tree_leaves(params), history, count, text.getvalue())
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, from one 4-process gloo run for the file."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path_factory.mktemp("gloo_pods"))
    mp.spawn(_worker, args=(tmp,), nprocs=W, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(W)]


def _rcfg(path, mode, wire="packed", vd="float32", overlap=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return RefSyncConfig(bucketed=path == "bucketed", wire=wire,
                             **BASE, **MODES[mode], value_dtype=vd,
                             overlap=overlap)


_REF = {}


def _reference(path, mode, vd="float32", overlap=None):
    """The reference's (2, 2) sync under nested vmap over ("pod", "data")
    on the packed wire (its packed and unpacked wires give the same bits),
    at ``overlap``: (update leaves, memory leaves), each with leading
    (pod, data) axes."""
    if (path, mode, vd, overlap) in _REF:
        return _REF[path, mode, vd, overlap]
    rcfg = _rcfg(path, mode, vd=vd, overlap=overlap)
    mems, grads = zip(*(_inputs(path, r) for r in range(W)))

    def stack(*xs):
        return jnp.stack([jnp.asarray(x) for x in xs]).reshape(
            (PODS, DATA) + np.shape(xs[0]))

    g = jax.tree.map(stack, *grads)
    if path == "bucketed":
        plan = rbk.make_plan(jax.tree.map(jnp.asarray, grads[0]), cols=COLS)
        m = tuple(stack(*bs) for bs in zip(*mems))
        ks = jnp.asarray(LIVE, jnp.int32) if mode == "dynamic" else None

        def fn(m, g):
            return ref_bucketed(rcfg, plan, m, g, jnp.float32(ETA),
                                pod_ks=ks)[:2]
    else:
        m = jax.tree.map(stack, *mems)

        def fn(m, g):
            return ref_leaf(rcfg, m, g, jnp.float32(ETA), COL_AXES)[:2]
    upd, mem = jax.jit(jax.vmap(jax.vmap(fn, axis_name="data"),
                                axis_name="pod"))(m, g)
    _REF[path, mode, vd, overlap] = (
        [np.asarray(x) for x in jax.tree.leaves(upd)],
        [np.asarray(x) for x in jax.tree.leaves(mem)])
    return _REF[path, mode, vd, overlap]


def _ref_bytes(path, mode, wire, vd="float32", **kw):
    """The reference's bytes per step of a case (``kw``: by level)."""
    rcfg = _rcfg(path, mode, wire, vd)
    _, grads = _inputs(path, 0)
    if path == "per-leaf":
        return ref_leaf_bytes(rcfg, grads, COL_AXES)
    plan = rbk.make_plan(jax.tree.map(jnp.asarray, grads), cols=COLS)
    return ref_bucket_bytes(rcfg, plan, **kw)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def test_ranks_form_the_pod_data_layout(runs):
    assert [r["layout"] for r in runs] == [(p, d, W, "pod")
                                           for p in range(PODS)
                                           for d in range(DATA)]


@pytest.mark.parametrize("path,mode,wire", CASES)
def test_two_level_sync_matches_reference(runs, path, mode, wire):
    r_upd, r_mem = _reference(path, mode)
    kw = dict(n_data=DATA) if mode == "dynamic" else {}
    r_nbytes = _ref_bytes(path, mode, wire, **kw)
    for rank in range(W):
        p, d = divmod(rank, DATA)
        upd, mem, nbytes, level = runs[rank][(path, mode, wire)]
        assert nbytes == r_nbytes
        assert len(upd) == len(r_upd) and len(mem) == len(r_mem)
        for a, b in zip(upd, r_upd):
            a, b = a.numpy(), b[p, d]
            np.testing.assert_array_equal(a != 0, b != 0)  # the support
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        for a, b in zip(mem, r_mem):
            np.testing.assert_allclose(a.numpy(), b[p, d], rtol=0,
                                       atol=1e-6)
        if path == "bucketed":
            # the bytes each level realized: at the live ks through the
            # repack boundary, else the static (or padded) gathers
            live = dict(pod_ks=LIVE) if mode == "dynamic" else {}
            want = _ref_bytes(path, mode, wire, by_level=True, **live)
            assert level == {"intra": want["intra"], "cross": want["cross"]}


@pytest.mark.parametrize("path,mode,wire", BF16_CASES)
def test_two_level_sync_at_bf16_matches_reference(runs, path, mode, wire):
    """The chain at bf16 wire values against the reference's: a sparse
    leaf's update (the cross-pod mean densified in bf16) bit for bit; the
    dense leaves' update (the float32 mean of u) and the memory (u - own
    plus the bf16 pod residual widened to float32) within the reference's
    FMA allowance on u (1e-6); the bytes, also by level, equal."""
    vd = "bfloat16"
    dense_below = _cfg(path, mode, wire, vd).dense_below
    r_upd, r_mem = _reference(path, mode, vd)
    kw = dict(n_data=DATA) if mode == "dynamic" else {}
    r_nbytes = _ref_bytes(path, mode, wire, vd, **kw)
    for rank in range(W):
        p, d = divmod(rank, DATA)
        upd, mem, nbytes, level = runs[rank][(path, mode, wire, vd)]
        assert nbytes == r_nbytes
        assert len(upd) == len(r_upd) and len(mem) == len(r_mem)
        for a, b in zip(upd, r_upd):
            a, b = a.numpy(), b[p, d]
            if a.size >= dense_below:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        for a, b in zip(mem, r_mem):
            np.testing.assert_allclose(a.numpy(), b[p, d], rtol=0,
                                       atol=1e-6)
        if path == "bucketed":
            live = dict(pod_ks=LIVE) if mode == "dynamic" else {}
            want = _ref_bytes(path, mode, wire, vd, by_level=True, **live)
            assert level == {"intra": want["intra"], "cross": want["cross"]}


@pytest.mark.parametrize("path,mode", sorted({c[:2] for c in BF16_CASES}))
def test_bf16_packed_equals_unpacked_and_ranks_agree(runs, path, mode):
    key = {w: (path, mode, w, "bfloat16") for w in ("packed", "unpacked")}
    for rank in range(W):
        p_upd, p_mem, _, _ = runs[rank][key["packed"]]
        u_upd, u_mem, _, _ = runs[rank][key["unpacked"]]
        for a, b in zip(p_upd + p_mem, u_upd + u_mem):
            assert torch.equal(_bits(a), _bits(b))
    for rank in range(1, W):  # one update on every rank
        for a, b in zip(runs[0][key["packed"]][0],
                        runs[rank][key["packed"]][0]):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("path,mode", sorted({c[:2] for c in CASES}))
def test_packed_equals_unpacked_and_ranks_agree(runs, path, mode):
    for rank in range(W):
        p_upd, p_mem, _, _ = runs[rank][(path, mode, "packed")]
        u_upd, u_mem, _, _ = runs[rank][(path, mode, "unpacked")]
        for a, b in zip(p_upd + p_mem, u_upd + u_mem):
            assert torch.equal(_bits(a), _bits(b))
    for rank in range(1, W):  # one update on every rank
        for a, b in zip(runs[0][(path, mode, "packed")][0],
                        runs[rank][(path, mode, "packed")][0]):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("path,mode", sorted({c[:2] for c in CASES}))
def test_mass_is_conserved(runs, path, mode):
    """Invariant 8: mean_w(u) == update + mean_w(new memory), with u = m
    + eta*g of each rank (both levels' residuals in the memory); in
    bucket space on the bucketed path, without the padding tail."""
    from repro_torch.core import buckets as bk

    eta = np.float32(ETA)
    upd = runs[0][(path, mode, "packed")][0]
    if path == "bucketed":
        plan = bk.make_plan(params_from_jax(_inputs(path, 0)[1]), cols=COLS)

        def flat(bufs):
            return np.concatenate([np.ravel(np.asarray(b))[:s.size]
                                   for b, s in zip(bufs, plan.buckets)])

        def grads(g_np):
            return [b.numpy() for b in bk.pack(plan, params_from_jax(g_np))]

        upd = flat([b.numpy() for b in bk.pack(
            plan, plan.treedef.unflatten(upd))])
    else:
        def flat(leaves):
            return np.concatenate([np.ravel(np.asarray(x)) for x in leaves])

        def grads(g_np):
            return jax.tree.leaves(g_np)

        upd = flat([x.numpy() for x in upd])
    us, mems = [], []
    for rank in range(W):
        m_np, g_np = _inputs(path, rank)
        m_np = m_np if path == "bucketed" else jax.tree.leaves(m_np)
        us.append(flat(m_np) + eta * flat(grads(g_np)))
        mems.append(flat([x.numpy() for x in
                          runs[rank][(path, mode, "packed")][1]]))
    mean_u = np.mean(us, axis=0)
    err = np.max(np.abs(mean_u - (upd + np.mean(mems, axis=0))))
    assert err <= 1e-6 * np.max(np.abs(mean_u)), err


@pytest.mark.parametrize("case", CASES + [c + ("bfloat16",)
                                          for c in BF16_CASES])
def test_overlap_modes_are_bitwise_equal_at_four_workers(runs, case):
    """Overlap False and True give overlap None's update, memory, bytes
    and bytes by level bit for bit on every rank: the static pod k, the
    per-bucket ratios, the runtime pod k through the repack boundary
    (its R stage in the chain) and the per-leaf chain, both wires,
    float32 and bf16 wire values."""
    for r in runs:
        upd, mem, nbytes, level = r[case]
        for overlap in (False, True):
            o_upd, o_mem, o_nbytes, o_level = r[case + ("overlap", overlap)]
            assert (o_nbytes, o_level) == (nbytes, level)
            assert len(o_upd + o_mem) == len(upd + mem)
            for a, b in zip(o_upd + o_mem, upd + mem):
                assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("path,mode", sorted({c[:2] for c in CASES}))
def test_overlap_on_matches_reference_at_four_workers(runs, path, mode):
    """The port's overlap=True two-level sync on the packed wire against
    the reference's traced at overlap=True under the same nested vmap
    (its double-buffered schedule): the support exactly, update and
    memory within 1e-6."""
    r_upd, r_mem = _reference(path, mode, overlap=True)
    for rank, r in enumerate(runs):
        p, d = divmod(rank, DATA)
        upd, mem, _, _ = r[(path, mode, "packed", "overlap", True)]
        assert len(upd) == len(r_upd) and len(mem) == len(r_mem)
        for a, b in zip(upd, r_upd):
            a, b = a.numpy(), b[p, d]
            np.testing.assert_array_equal(a != 0, b != 0)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        for a, b in zip(mem, r_mem):
            np.testing.assert_allclose(a.numpy(), b[p, d], rtol=0,
                                       atol=1e-6)


def test_selfchecks_hold_on_the_four_rank_layout(runs):
    """The port's ``overlap_selfcheck`` (both wires) and
    ``repack_selfcheck`` on the (2, 2) layout: every flag True on every
    rank; the repack check's (padded, live) cross-pod bytes those of the
    reference's accounting at n_data 2 (its selfchecks are not run: they
    are 8-device subprocesses)."""
    from repro.core import encoding as renc

    for r in runs:
        ov_packed, ov_unpacked, rp = r["selfchecks"]
        for ov in (ov_packed, ov_unpacked):
            assert ov == {"flat_bitwise": True, "hierarchical_bitwise": True,
                          "pod_dynamic_bitwise": True, "bitwise_all": True}
        assert rp["repack_bitwise"] and rp["transport_roundtrip_bitwise"]
        assert rp["transport_accounting_exact"]
        # the probe's sparse bucket: (48, 128), k_row 6, pod k 9, k_max
        # the support bound n_data * k_row = 12; the live k 4
        rcfg = RefSyncConfig(ratio=0.05, strategy="hierarchical",
                             pod_axis="pod", bucketed=True, bucket_cols=128,
                             wire="packed", pod_ratios=(1.0, 9 / 128),
                             pod_dynamic=True, _warn=False)
        k_max = rcfg.pod_k_max_for_bucket(1, 128, DATA)
        assert rp["padded_vs_live_bytes"] == [
            renc.WireSpec(48, 128, k_max).nbytes,
            renc.message_nbytes(48, 128, 4, "float32", "packed")]


def test_refresh_run_with_overlap_on_is_bitwise_the_refresh_run(runs):
    """The pod_budgeted refresh run through ``train()`` with the double
    buffer (its pod ks refreshed every 2 steps: live-k switches, the
    repack boundary) gives the refresh run's params and memory bit for
    bit on every rank."""
    for r in runs:
        t = r["train"]
        for a, b in zip(t["refresh overlap"], t["refresh"]):
            assert torch.equal(_bits(a), _bits(b))


def test_constant_live_k_equals_static_bitwise(runs):
    """Invariant 9: the runtime pod k at a constant live 7 (shapes at k_max
    20, the tail masked to (-0.0, 0)) gives the static pod k 7's update
    and memory bit for bit."""
    for rank in range(W):
        for wire in ("unpacked", "packed"):
            dyn = runs[rank][("bucketed", "dynamic", wire)]
            sta = runs[rank][("bucketed", "ratios", wire)]
            for a, b in zip(dyn[0] + dyn[1], sta[0] + sta[1]):
                assert torch.equal(_bits(a), _bits(b))


def test_refresh_schedule_replays_bitwise(runs):
    """Invariant 9 through the driver: a fresh run fed the refreshed run's
    recorded schedule gives its params and memory bit for bit, and every
    rank recorded the same schedule."""
    first = runs[0]["train"]
    assert [i for i, _ in first["schedule"]] == [2, 4]
    assert all(c <= first["budget"] for c in first["cross"])
    for r in runs:
        t = r["train"]
        assert t["schedule"] == first["schedule"]
        assert t["initial"] == first["initial"]
        for a, b in zip(t["refresh"], t["replay"]):
            assert torch.equal(_bits(a), _bits(b))
    for r in runs[1:]:  # the params: one copy on every rank
        for a, b in zip(runs[0]["main"][0], r["main"][0]):
            assert torch.equal(_bits(a), _bits(b))


_REF_MODEL = {}


def _ref_model_params():
    """The reference's smoke model and the port's seed-0 params in its
    layout, with the plan over them (cached in ``_REF_MODEL`` with the
    reference's calibrators)."""
    if not _REF_MODEL:
        rmodel = ref_build_model(ref_get_smoke_config(ARCH).replace(
            compute_dtype="float32"))
        params = jax.tree.map(jnp.asarray, params_to_jax(
            _small_model().init(seed=0, device="cpu")))
        _REF_MODEL["v"] = (rmodel, params, rbk.make_plan(
            params, cols=1024, dense_below=16_384))
    return _REF_MODEL["v"]


def _ref_ratios(batch, eta, n_data, mode, budget, memory=None,
                k_caps=None, vd="float32"):
    """The reference's PodRatioCalibrator and allocation on the global
    ``batch`` (numpy), ``memory``: per bucket, every worker's buffer
    stacked in rank order."""
    from repro.launch.train import PodRatioCalibrator as RefCalibrator
    from repro.launch.train import _calibrate_pod_ratios as ref_calibrate

    rmodel, params, plan = _ref_model_params()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rsync = _cal_sync(mode, budget, RefSyncConfig, vd)
    if n_data not in _REF_MODEL:  # one jitted gradient for each n_data
        _REF_MODEL[n_data] = RefCalibrator(rmodel, plan, n_data)
    bufs = _REF_MODEL[n_data].u_bufs(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, eta,
        memory=memory)
    return tuple(float(r) for r in ref_calibrate(rsync, plan, bufs, n_data,
                                                  k_caps=k_caps))


@pytest.mark.parametrize("layout,mode,mem", CAL_CASES)
def test_pod_ratio_calibrator_matches_reference(runs, layout, mode, mem):
    """The distributed calibration (the global batch gathered from the
    ranks' slices; at (2, 2) pod 0's shards with their own memory, their
    selections gathered in pod 0's data group and densified on rank 0; at
    (4, 1) the global u with the mean of every worker's memory; rank 0's
    allocation broadcast) gives the reference's ratios on the same global
    batch and the same memories, on every rank."""
    budget = runs[0]["train"]["budget"]
    got = [r["calibration"][layout, mode, mem] for r in runs]
    assert all(g == got[0] for g in got[1:])
    model = _small_model()
    plan = _small_plan(model)
    memory = None
    if mem:
        per_rank = [_cal_memory(plan, r) for r in range(W)]
        memory = [jnp.stack([jnp.asarray(m[b]) for m in per_rank])
                  for b in range(len(plan.buckets))]
    want = _ref_ratios(_cal_batch(model.cfg.vocab_size), ETA, layout[1],
                       mode, budget, memory, _cal_caps(plan, mem))
    assert got[0] == want


@pytest.mark.parametrize("layout,mode,mem", BF16_CAL_CASES)
def test_pod_ratio_calibrator_at_bf16_matches_reference(runs, layout, mode,
                                                        mem):
    """The same at bf16 wire values: the reference measures the shards'
    selections in float32 whatever the wire's dtype, and sizes the
    budget's messages in bf16."""
    budget = runs[0]["train"]["budget"]
    got = [r["calibration"][layout, mode, mem, "bfloat16"] for r in runs]
    assert all(g == got[0] for g in got[1:])
    plan = _small_plan(_small_model())
    per_rank = [_cal_memory(plan, r) for r in range(W)]
    memory = [jnp.stack([jnp.asarray(m[b]) for m in per_rank])
              for b in range(len(plan.buckets))]
    want = _ref_ratios(_cal_batch(_small_model().cfg.vocab_size), ETA,
                       layout[1], mode, budget, memory,
                       _cal_caps(plan, mem), vd="bfloat16")
    assert got[0] == want


def test_pod_mean_proxy_is_float32_at_bf16_wire_values(runs):
    """The calibration's simulated pod mean (pod 0's shards' top-k_row,
    moved through the data group, densified on rank 0) does not depend on
    the wire's dtype: the reference's ``simulate_pod_mean`` measures in
    float32, and the float32 one is held against it above."""
    cal = runs[0]["calibration"]
    f32, bf16 = cal["float32", "pod means"], cal["bfloat16", "pod means"]
    assert len(f32) == len(bf16) > 0
    for a, b in zip(f32, bf16):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(_bits(a), _bits(b))


def test_train_initial_pod_ks_match_reference(runs):
    """The water-filled run's first calibration through ``train()`` (the
    first batch at zero memory) gives the reference's pod ks."""
    from repro_torch.data import token_batches

    t = runs[0]["train"]
    model = _small_model()
    plan = _small_plan(model)
    batch = next(token_batches(model.cfg.vocab_size, TRAIN["batch"],
                               TRAIN["seq"], seed=3))
    ratios = _ref_ratios(batch, TRAIN["eta"], DATA, "budget", t["budget"])
    want = tuple(round(r * s.cols) if s.kind == "sparse" else 1
                 for r, s in zip(ratios, plan.buckets))
    assert tuple(t["initial"]) == want


def test_four_rank_main_matches_the_full_batch_reference(runs):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import token_batches
    from repro_torch.models import build_model

    (p0, h0, c0, text0), *rest = (r["main"] for r in runs)
    assert c0 == 3 and all(h == h0 and c == c0 for _, h, c, _ in rest)
    assert "pod autotune: ratios=" in text0
    assert "pod refresh @ step 2" in text0
    assert all(text == "" for *_, text in rest)  # only rank 0 prints
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    params = params_to_jax(build_model(cfg).init(seed=0, device="cpu"))
    batch = next(token_batches(cfg.vocab_size, 4, 32, seed=0))
    rmodel = ref_build_model(ref_get_smoke_config(ARCH).replace(
        compute_dtype="float32"))
    _, metrics = jax.jit(rmodel.loss)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(h0[0][1], float(metrics["xent"]), rtol=1e-5)


_QREF = {}


def _quant_reference(mode):
    """The reference's quantized (2, 2) sync under nested vmap over
    ("pod", "data") on the packed wire, its quant_key
    fold_in(PRNGKey(QSEED), QSTEP): (update leaves, memory buffers), each
    with leading (pod, data) axes."""
    if mode in _QREF:
        return _QREF[mode]
    rcfg = _qcfg(mode, "packed", pkg="ref")
    mems, grads = zip(*(_inputs("bucketed", r) for r in range(W)))

    def stack(*xs):
        return jnp.stack([jnp.asarray(x) for x in xs]).reshape(
            (PODS, DATA) + np.shape(xs[0]))

    plan = rbk.make_plan(jax.tree.map(jnp.asarray, grads[0]), cols=COLS)
    ks = jnp.asarray(LIVE, jnp.int32) if mode == "dynamic" else None
    qkey = jax.random.fold_in(jax.random.PRNGKey(QSEED), QSTEP)

    def fn(m, g):
        return ref_bucketed(rcfg, plan, m, g, jnp.float32(ETA), pod_ks=ks,
                            quant_key=qkey)[:2]

    upd, mem = jax.jit(jax.vmap(jax.vmap(fn, axis_name="data"),
                                axis_name="pod"))(
        tuple(stack(*bs) for bs in zip(*mems)), jax.tree.map(stack, *grads))
    _QREF[mode] = ([np.asarray(x) for x in jax.tree.leaves(upd)],
                   [np.asarray(x) for x in mem])
    return _QREF[mode]


def _quant_level_bytes(mode, wire):
    """The reference's bytes by level of a quantized case: at the live ks
    through the repack boundary."""
    _, grads = _inputs("bucketed", 0)
    plan = rbk.make_plan(jax.tree.map(jnp.asarray, grads), cols=COLS)
    live = dict(pod_ks=LIVE) if mode == "dynamic" else {}
    lv = ref_bucket_bytes(_qcfg(mode, wire, pkg="ref"), plan, by_level=True,
                          **live)
    kw = dict(n_data=DATA) if mode == "dynamic" else {}
    return ({"intra": lv["intra"], "cross": lv["cross"]},
            ref_bucket_bytes(_qcfg(mode, wire, pkg="ref"), plan, **kw))


@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("wire", ["unpacked", "packed"])
def test_quantized_two_level_sync_matches_reference(runs, mode, wire):
    r_upd, r_mem = _quant_reference(mode)
    level_want, bytes_want = _quant_level_bytes(mode, wire)
    for rank, r in enumerate(runs):
        p, d = divmod(rank, DATA)
        upd, mem, nbytes, level, _ = r["quant"][mode, wire, "ref"]
        assert nbytes == bytes_want and level == level_want
        assert len(upd) == len(r_upd) and len(mem) == len(r_mem)
        for a, b in zip(upd + mem, r_upd + r_mem):
            b = b[p, d]
            np.testing.assert_allclose(
                a.numpy(), b, rtol=0, atol=1e-6 + 4e-7 * np.abs(b).max())


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_quantized_two_level_sync_with_the_ports_noise(runs, mode):
    """The port's own noise: both ranks of a pod draw the same level-2
    codes (the pod summary's, level 2 of each bucket), packed ==
    unpacked and the four ranks' updates bit for bit, the bytes by level
    the accounting, mean_w(u) == update + mean_w(m') within 1e-5 in
    bucket space without the padding tail."""
    from repro_torch.core import buckets as bk

    cases = [r["quant"] for r in runs]
    for pod in range(PODS):
        first = cases[pod * DATA][mode, "packed", "own"][4]
        assert len(first) == 2  # the sparse bucket's two levels
        for d in range(1, DATA):
            codes = cases[pod * DATA + d][mode, "packed", "own"][4]
            assert torch.equal(codes[1], first[1])
    for c in cases:
        p, u = c[mode, "packed", "own"], c[mode, "unpacked", "own"]
        for a, b in zip(p[0] + p[1], u[0] + u[1]):
            assert torch.equal(_bits(a), _bits(b))
        for a, b in zip(p[0], cases[0][mode, "packed", "own"][0]):
            assert torch.equal(_bits(a), _bits(b))
        assert (p[3], p[2]) == _quant_level_bytes(mode, "packed")
    plan = bk.make_plan(params_from_jax(_inputs("bucketed", 0)[1]),
                        cols=COLS)
    upd = bk.pack(plan, plan.treedef.unflatten(
        cases[0][mode, "packed", "own"][0]))
    eta = np.float32(ETA)
    for b, spec in enumerate(plan.buckets):
        us, ms = [], []
        for rank in range(W):
            m_np, g_np = _inputs("bucketed", rank)
            g = bk.pack(plan, params_from_jax(g_np))[b].numpy()
            us.append(m_np[b] + eta * g)
            ms.append(cases[rank][mode, "packed", "own"][1][b].numpy())
        err = np.abs(np.mean(us, 0) - (upd[b].numpy() + np.mean(ms, 0)))
        assert err.ravel()[:spec.size].max() <= 1e-5


def test_local_quant_selfcheck_on_the_four_rank_layout(runs):
    for r in runs:
        out = r["local_quant_selfcheck"]
        assert out["quant_conservation_max_err"] < 1e-5
        assert out["h1_accum_bitwise"] and out["quant_bit_identical"]
        assert out["quant_accounting_exact"] and out["amortized_ratio_exact"]
