"""The port's bucketed sync at one worker, on both wires, against the
reference's ``bucketed_sync_gradients`` inside a 1-device ``shard_map``
(the ``tests/test_buckets.py`` pattern); its presets and byte accounting
against the reference's. More than one worker: ``test_torch_workers.py``.

Tolerances: the same (m, g) give the same selection (the update's
support is compared exactly), and update and memory agree within 1e-6
(the reference's FMA allowance on ``m + eta*g``). The sign of a zero may
differ — the reference forms the memory as ``u - own``, the kernel zeroes
the selected entries — so values are compared with ``==``-style
tolerances, not byte views.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import buckets as rbk
from repro.core.distributed import SyncConfig as RefSyncConfig
from repro.core.distributed import bucketed_message_bytes as ref_message_bytes
from repro.core.distributed import bucketed_sync_gradients as ref_sync
from repro.utils.compat import shard_map
from repro_torch.convert import params_from_jax
from repro_torch.core import buckets as bk
from repro_torch.core.distributed import (
    SyncConfig,
    bucketed_message_bytes,
    bucketed_sync_gradients,
)
from repro_torch.utils.tree import tree_leaves

COLS = 512
ETA = 0.3


def _tree_np(seed=0):
    rng = np.random.default_rng(seed)

    def f32(*s):
        return rng.standard_normal(s).astype(np.float32)

    return {"w1": f32(128, 256), "w2": f32(300, 70), "blk": {"z": f32(90, 200)},
            "b": f32(64), "s": f32(8, 16)}


def _ref_cfg(cfg: SyncConfig) -> RefSyncConfig:
    return RefSyncConfig(
        strategy=cfg.strategy, ratio=cfg.ratio, bucketed=True,
        bucket_cols=cfg.bucket_cols, selection=cfg.selection,
        wire=cfg.wire, value_dtype=cfg.value_dtype, _warn=False)


def _run_both(cfg: SyncConfig, seed=0):
    tree_np = _tree_np(seed)
    tree = params_from_jax(tree_np)
    plan = bk.make_plan(tree, cols=COLS)
    ref_tree = jax.tree.map(jnp.asarray, tree_np)
    rplan = rbk.make_plan(ref_tree, cols=COLS)
    rng = np.random.default_rng(seed + 1)
    mem_np = [rng.standard_normal(s.shape).astype(np.float32)
              for s in plan.buckets]
    upd, mem, nbytes = bucketed_sync_gradients(
        cfg, plan, [torch.from_numpy(m) for m in mem_np], tree, ETA)

    rcfg = _ref_cfg(cfg)

    def body(mem, tree):
        u, m, _ = ref_sync(rcfg, rplan, mem, tree, jnp.float32(ETA))
        return u, m

    ref_mem = tuple(jnp.asarray(m) for m in mem_np)
    spec = lambda t: jax.tree.map(lambda _: P(), t)  # noqa: E731
    r_upd, r_mem = jax.jit(shard_map(
        body, mesh=jax.make_mesh((1,), ("data",)),
        in_specs=(spec(ref_mem), spec(ref_tree)),
        out_specs=(spec(ref_tree), spec(ref_mem)),
    ))(ref_mem, ref_tree)
    return (upd, mem, nbytes), (r_upd, r_mem, ref_message_bytes(rcfg, rplan))


def _assert_agree(got, want):
    (upd, mem, nbytes), (r_upd, r_mem, r_nbytes) = got, want
    for a, b in zip(tree_leaves(upd), jax.tree.leaves(r_upd)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(a != 0, b != 0)  # the same selection
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert len(mem) == len(r_mem)
    for a, b in zip(mem, r_mem):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    assert nbytes == r_nbytes


@pytest.mark.parametrize("selection", ["argmax_onehot", "threshold_onehot"])
def test_sparse_allgather_matches_reference(selection):
    cfg = SyncConfig(ratio=0.02, bucketed=True, bucket_cols=COLS,
                     selection=selection)
    _assert_agree(*_run_both(cfg))


def test_bf16_wire_values_match_reference():
    cfg = SyncConfig(ratio=0.02, bucketed=True, bucket_cols=COLS,
                     value_dtype="bfloat16")
    _assert_agree(*_run_both(cfg, seed=2))


def test_dense_strategy_matches_reference():
    cfg = SyncConfig(strategy="dense", bucketed=True, bucket_cols=COLS)
    got, want = _run_both(cfg, seed=3)
    _assert_agree(got, want)
    for m in got[1]:
        assert not m.any()  # all of u ships, nothing stays in memory


def test_message_bytes_match_reference():
    tree = {"w": torch.empty((300, 700), device="meta"),
            "b": torch.empty((100,), device="meta")}
    rtree = {"w": jax.ShapeDtypeStruct((300, 700), jnp.float32),
             "b": jax.ShapeDtypeStruct((100,), jnp.float32)}
    plan, rplan = bk.make_plan(tree), rbk.make_plan(rtree)
    for cfg in (SyncConfig(ratio=0.01, bucketed=True),
                SyncConfig(ratio=0.05, bucketed=True, value_dtype="bfloat16"),
                SyncConfig(strategy="dense", bucketed=True),
                SyncConfig(ratio=0.03, bucketed=True, wire="packed"),
                SyncConfig(ratio=0.05, bucketed=True, wire="packed",
                           value_dtype="bfloat16")):
        assert bucketed_message_bytes(cfg, plan) == ref_message_bytes(
            _ref_cfg(cfg), rplan)


@pytest.mark.parametrize("change,name", [
    # the ids of the cases kept from before the packed wire was ported.
    # Every option is ported since the quantized wire and local steps
    # were: the quantized wire at bf16 wire values is refused by name with
    # the reference's error, and the other mixes validate as the
    # reference's do
    pytest.param(dict(strategy="hierarchical", pod_axis="pod",
                      value_dtype="bfloat16", overlap=True, quant=15),
                 "quant", id="change0-hierarchical"),
    pytest.param(dict(quant=15), None, id="change2-quant"),
    pytest.param(dict(local_steps=4), None, id="change3-local_steps"),
    pytest.param(dict(overlap=True, local_steps=4), None,
                 id="change4-overlap"),
])
def test_unported_options_raise_by_name(change, name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        cfg = dataclasses.replace(SyncConfig(bucketed=True), **change)
        rcfg = dataclasses.replace(RefSyncConfig(bucketed=True), **change)
    if name is None:
        assert cfg.validate() is cfg
        rcfg.validate()
        return
    with pytest.raises(ValueError, match=name) as ours:
        cfg.validate()
    with pytest.raises(ValueError) as ref:
        rcfg.validate()
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("change", [dict(strategy="ring"),
                                    dict(selection="sortnet"),
                                    dict(wire="zip"),
                                    dict(value_dtype="float16")])
def test_unknown_values_raise(change):
    with pytest.raises(ValueError):
        dataclasses.replace(SyncConfig(bucketed=True), **change).validate()


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("selection", ["argmax_onehot", "threshold_onehot"])
def test_packed_wire_matches_reference(selection, value_dtype):
    """The packed wire at one worker against the reference's packed sync
    in its 1-device shard_map; its bytes are the packed buffers'."""
    cfg = SyncConfig(ratio=0.02, bucketed=True, bucket_cols=COLS,
                     selection=selection, wire="packed",
                     value_dtype=value_dtype)
    _assert_agree(*_run_both(cfg, seed=4))


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_packed_equals_unpacked_bitwise(value_dtype):
    """The reference's packed == unpacked invariant, inside the port."""
    out = {}
    for wire in ("unpacked", "packed"):
        cfg = SyncConfig(ratio=0.05, bucketed=True, bucket_cols=COLS,
                         wire=wire, value_dtype=value_dtype)
        tree = params_from_jax(_tree_np(5))
        plan = bk.make_plan(tree, cols=COLS)
        mem = [torch.from_numpy(np.random.default_rng(6).standard_normal(
            s.shape).astype(np.float32)) for s in plan.buckets]
        upd, new_mem, _ = bucketed_sync_gradients(cfg, plan, mem, tree, ETA)
        out[wire] = tree_leaves(upd) + list(new_mem)
    for a, b in zip(out["unpacked"], out["packed"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_path_bytes_match_the_reference():
    """The topk preset's bytes per step at qwen3-4b full width, 4 layers
    (1154560 rows of 1024 at k = 20, a dense bucket of 24064), for every
    wire and value dtype, against the reference's accounting."""
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build_model
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    plan = bk.make_plan(build_model(get_config("qwen3-4b").replace(
        n_layers=4)).param_shapes())
    rplan = rbk.make_plan(ref_build_model(ref_get_config("qwen3-4b").replace(
        n_layers=4)).param_shapes())
    want = {("packed", "float32"): 124_788_768,
            ("packed", "bfloat16"): 78_606_368,
            ("unpacked", "float32"): 184_825_856,
            ("unpacked", "bfloat16"): 138_643_456}
    for (wire, vd), nbytes in want.items():
        cfg = SyncConfig.preset("topk", ratio=0.02, wire=wire, value_dtype=vd)
        assert bucketed_message_bytes(cfg, plan) == nbytes
        assert ref_message_bytes(_ref_cfg(cfg), rplan) == nbytes
    dense = SyncConfig.preset("dense", bucketed=True)
    assert bucketed_message_bytes(dense, plan) == 4_729_174_016


@pytest.mark.parametrize("name,overrides", [
    ("topk", {}), ("topk", dict(ratio=0.02)),
    ("topk", dict(wire="unpacked", value_dtype="bfloat16")),
    ("dense", {}), ("dense", dict(bucketed=True, ratio=0.05)),
    ("pod_budgeted", dict(pod_axis="pod", byte_budget=185_587))])
def test_presets_match_reference(name, overrides):
    cfg = SyncConfig.preset(name, **overrides)
    rcfg = RefSyncConfig.preset(name, **overrides)
    for field in dataclasses.fields(cfg):
        got, want = getattr(cfg, field.name), getattr(rcfg, field.name)
        if dataclasses.is_dataclass(got):  # the pod, wire and transport
            got, want = dataclasses.astuple(got), dataclasses.astuple(want)
        assert got == want, field
    cfg.validate()


@pytest.mark.parametrize("name,overrides,words", [
    # every preset is ported since qsparse_local was: it validates as the
    # reference's; the quantized wire at bf16 wire values on pod_budgeted
    # is refused by name with the reference's error
    pytest.param("qsparse_local", {}, None,
                 id="qsparse_local-local steps"),
    pytest.param("pod_budgeted", dict(pod_axis="pod", value_dtype="bfloat16",
                                      overlap=True, quant=15),
                 "quant", id="pod_budgeted-hierarchical")])
def test_unported_presets_raise_by_name(name, overrides, words):
    rcfg = RefSyncConfig.preset(name, **overrides)
    if words is None:
        SyncConfig.preset(name, **overrides).validate()
        rcfg.validate()
    else:
        with pytest.raises(ValueError, match=words) as ours:
            SyncConfig.preset(name, **overrides).validate()
        with pytest.raises(ValueError) as ref:
            rcfg.validate()
        assert str(ours.value) == str(ref.value)
    if name == "pod_budgeted":  # without quant it validates, overlap on
        overrides = {k: v for k, v in overrides.items() if k != "quant"}
        SyncConfig.preset(name, **overrides).validate()
    with pytest.raises(ValueError, match="unknown SyncConfig preset"):
        SyncConfig.preset("bogus")


def test_k_for_matches_reference():
    for ratio, k_min, k_max in [(0.01, 1, None), (0.001, 3, None),
                                (0.5, 1, 7)]:
        cfg = SyncConfig(ratio=ratio, k_min=k_min, k_max=k_max)
        rcfg = RefSyncConfig(ratio=ratio, k_min=k_min, k_max=k_max)
        for c in (1, 33, 1024, 8192):
            assert cfg.k_for(c) == rcfg.k_for(c)
