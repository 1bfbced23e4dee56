"""The port's per-leaf sync at one worker, on both wires, against the
reference's ``sparse_sync_gradients`` inside a 1-device ``shard_map`` (the
``tests/test_torch_sync.py`` pattern), and its byte accounting and column
axes against the reference's.

Tolerances: the same (m, g) give the same selection (the update's support
is compared exactly), and update and memory agree within 1e-6 (the
reference's FMA allowance on ``m + eta*g``). The sign of a zero may differ
(the reference densifies with a one-hot einsum), so values are compared
as numbers, not as bytes. Byte counts and column axes are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core.distributed import SyncConfig as RefSyncConfig
from repro.core.distributed import message_bytes as ref_message_bytes
from repro.core.distributed import sparse_sync_gradients as ref_sync
from repro.launch.sharding import sync_col_axes as ref_sync_col_axes
from repro.models import build_model as ref_build_model
from repro.utils.compat import shard_map
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import distributed as dist
from repro_torch.core.distributed import (
    SyncConfig,
    message_bytes,
    sparse_sync_gradients,
)
from repro_torch.kernels.topk_select import LAUNCHES
from repro_torch.launch.sharding import sync_col_axes
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_leaves

ETA = 0.3
# w1 selects along axis 0 (C = 128, k = 3 at ratio 0.02), w2 along its
# middle axis (C = 64, k = 1), z and v along the last (C = 200, k = 4;
# C = 300, k = 6); b and s sync densely (below dense_below)
COL_AXES = {"w1": 0, "w2": 1, "blk": {"z": 1, "v": None}, "b": None,
            "s": None}


def _tree_np(seed):
    rng = np.random.default_rng(seed)

    def f32(*s):
        return rng.standard_normal(s).astype(np.float32)

    return {"w1": f32(128, 256), "w2": f32(3, 64, 100),
            "blk": {"z": f32(90, 200), "v": f32(60, 300)},
            "b": f32(64), "s": f32(8, 16)}


def _ref_cfg(cfg: SyncConfig, layout="batched") -> RefSyncConfig:
    return RefSyncConfig(
        strategy=cfg.strategy, ratio=cfg.ratio, k_min=cfg.k_min,
        bucketed=False, selection=cfg.selection,
        argmax_k_limit=cfg.argmax_k_limit, layout=layout,
        wire=cfg.wire, value_dtype=cfg.value_dtype,
        dense_below=cfg.dense_below, _warn=False)


def _run_both(cfg: SyncConfig, seed=0, layout="batched"):
    grads_np, mem_np = _tree_np(seed), _tree_np(seed + 1)
    upd, mem, nbytes = sparse_sync_gradients(
        cfg, params_from_jax(mem_np), params_from_jax(grads_np), ETA,
        COL_AXES)

    rcfg = _ref_cfg(cfg, layout)
    ref_mem = jax.tree.map(jnp.asarray, mem_np)
    ref_grads = jax.tree.map(jnp.asarray, grads_np)
    ref_cols = jax.tree.map(lambda c: c, COL_AXES)

    def body(mem, grads):
        u, m, _ = ref_sync(rcfg, mem, grads, jnp.float32(ETA), ref_cols)
        return u, m

    spec = jax.tree.map(lambda _: P(), ref_mem)
    r_upd, r_mem = jax.jit(shard_map(
        body, mesh=jax.make_mesh((1,), ("data",)),
        in_specs=(spec, spec), out_specs=(spec, spec),
    ))(ref_mem, ref_grads)
    r_nbytes = ref_message_bytes(rcfg, ref_grads, ref_cols)
    return (upd, mem, nbytes), (r_upd, r_mem, r_nbytes)


def _assert_agree(got, want):
    (upd, mem, nbytes), (r_upd, r_mem, r_nbytes) = got, want
    for a, b in zip(tree_leaves(upd), jax.tree.leaves(r_upd)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a != 0, b != 0)  # the same selection
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in zip(tree_leaves(mem), jax.tree.leaves(r_mem)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    assert nbytes == r_nbytes


@pytest.mark.parametrize("selection,limit", [
    ("argmax_onehot", 64),     # the loop on every leaf
    ("argmax_onehot", 4),      # the threshold above k = 4
    ("threshold_onehot", 64),  # "auto": both sides of the CPU cutover (4)
    ("topk_scatter", 64),      # the threshold on every leaf
])
def test_sparse_allgather_matches_reference(selection, limit):
    cfg = SyncConfig(ratio=0.02, selection=selection, argmax_k_limit=limit)
    _assert_agree(*_run_both(cfg))


def test_flatten_layout_and_bf16_wire_match_reference():
    """The port's one row order equals the reference's flatten layout too."""
    cfg = SyncConfig(ratio=0.02, value_dtype="bfloat16")
    _assert_agree(*_run_both(cfg, seed=2, layout="flatten"))


def test_dense_strategy_matches_reference():
    got, want = _run_both(SyncConfig(strategy="dense"), seed=3)
    _assert_agree(got, want)
    for m in tree_leaves(got[1]):
        assert not m.any()  # all of u ships, nothing stays in memory


@pytest.mark.parametrize("selection,k,method", [
    ("argmax_onehot", 64, "loop"), ("argmax_onehot", 65, "threshold"),
    ("threshold_onehot", 3, "auto"), ("topk_scatter", 2, "threshold"),
])
def test_selection_maps_to_a_row_topk_method(selection, k, method):
    assert dist._row_topk_method(SyncConfig(selection=selection), k) == method


def test_cpu_sync_launches_no_kernel():
    before = dict(LAUNCHES)
    _run_both(SyncConfig(ratio=0.02), seed=4)
    assert LAUNCHES == before


def _shapes(arch, smoke):
    get, ref_get = ((get_smoke_config, ref_get_smoke_config) if smoke
                    else (get_config, ref_get_config))
    cfg = get(arch).replace(n_layers=4) if not smoke else get(arch)
    rcfg = ref_get(arch).replace(n_layers=cfg.n_layers)
    return (build_model(cfg).param_shapes(),
            ref_build_model(rcfg).param_shapes())


@pytest.mark.parametrize("smoke", [True, False])
def test_col_axes_and_message_bytes_match_reference(smoke):
    shapes, ref_shapes = _shapes("qwen3-4b", smoke)
    cols = sync_col_axes(shapes)
    ref_cols = ref_sync_col_axes(ref_shapes)
    assert cols == jax.tree.map(int, ref_cols)
    for cfg in (SyncConfig(ratio=0.01), SyncConfig(ratio=0.05, k_min=2),
                SyncConfig(ratio=0.01, value_dtype="bfloat16"),
                SyncConfig(strategy="dense"),
                SyncConfig(ratio=0.01, wire="packed"),
                SyncConfig(ratio=0.03, wire="packed",
                           value_dtype="bfloat16")):
        assert message_bytes(cfg, shapes, cols) == ref_message_bytes(
            _ref_cfg(cfg), ref_shapes, ref_cols)
    if not smoke:  # full width, 4 layers: 461,824 rows of 2560 at k = 26
        assert message_bytes(SyncConfig(ratio=0.01), shapes, cols) == \
            461_824 * 26 * 8 + 24_064 * 4


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("selection", ["argmax_onehot", "topk_scatter"])
def test_packed_wire_matches_reference(selection, value_dtype):
    """The per-leaf packed wire at one worker against the reference's in
    its 1-device shard_map (each leaf's rows one WireSpec message)."""
    cfg = SyncConfig(ratio=0.02, selection=selection, wire="packed",
                     value_dtype=value_dtype)
    _assert_agree(*_run_both(cfg, seed=7))


def test_packed_equals_unpacked_bitwise():
    out = {}
    for wire in ("unpacked", "packed"):
        cfg = SyncConfig(ratio=0.05, wire=wire, value_dtype="bfloat16")
        upd, mem, _ = sparse_sync_gradients(
            cfg, params_from_jax(_tree_np(8)), params_from_jax(_tree_np(9)),
            ETA, COL_AXES)
        out[wire] = tree_leaves(upd) + tree_leaves(mem)
    for a, b in zip(out["unpacked"], out["packed"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_path_bytes_match_the_reference():
    """The per-leaf path at qwen3-4b full width, 4 layers, ratio 0.02
    (461,824 rows of 2560 at k = 51, 24,064 dense floats)."""
    shapes, ref_shapes = _shapes("qwen3-4b", smoke=False)
    cols, ref_cols = sync_col_axes(shapes), ref_sync_col_axes(ref_shapes)
    for wire, nbytes in (("packed", 131_254_560), ("unpacked", 188_520_448)):
        cfg = SyncConfig(ratio=0.02, wire=wire)
        assert message_bytes(cfg, shapes, cols) == nbytes
        assert ref_message_bytes(_ref_cfg(cfg), ref_shapes, ref_cols) == nbytes


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_outputs_keep_the_parameter_layout_across_steps(value_dtype):
    """Update and memory come back contiguous in the parameters' layout
    for every leaf, the moved ones included, step after step, so the
    next step's u = m + eta*g and the parameter update see one layout."""
    cfg = SyncConfig(ratio=0.02, value_dtype=value_dtype)
    grads = params_from_jax(_tree_np(5))
    mem = params_from_jax(_tree_np(6))
    for _ in range(3):
        upd, mem, _ = sparse_sync_gradients(cfg, mem, grads, ETA, COL_AXES)
        for u, m, g in zip(tree_leaves(upd), tree_leaves(mem),
                           tree_leaves(grads)):
            assert u.shape == m.shape == g.shape
            assert u.is_contiguous() and m.is_contiguous()
