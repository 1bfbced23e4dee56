"""The port's bucketed flat-buffer engine against ``repro.core.buckets``.

Plans must be equal field for field (bucket order, kinds, rows, cols,
placements), packing is bitwise, and one error-feedback step over the
buckets agrees with the reference's within its FMA tolerance (1e-6;
indices follow from the support and are exact).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core import buckets as rbk
from repro.core.memsgd import constant_eta as ref_constant_eta
from repro.core.memsgd import memsgd_bucketed as ref_memsgd_bucketed
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import buckets as bk
from repro_torch.core.memsgd import constant_eta, memsgd_bucketed
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_leaves, tree_map


def _tree_np(seed=0):
    """Mixed sizes and dtypes, nested, keys inserted out of sorted order."""
    rng = np.random.default_rng(seed)

    def f32(*s):
        return rng.standard_normal(s).astype(np.float32)

    def bf16(*s):
        return rng.standard_normal(s).astype(ml_dtypes.bfloat16)

    return {
        "w2": f32(300, 70),                              # sparse f32
        "blk": {"z": f32(128, 256), "a": f32(64)},       # sparse + dense
        "h": bf16(200, 100),                             # sparse bf16
        "b": f32(64),                                    # dense f32
        "s": f32(8, 16),                                 # dense f32
        "hb": bf16(33),                                  # dense bf16
    }


def _both(tree_np):
    return (jax.tree.map(jnp.asarray, tree_np), params_from_jax(tree_np))


def _fields(plan):
    return ([dataclasses.astuple(s) for s in plan.buckets],
            [dataclasses.astuple(p) for p in plan.placements])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("cols,dense_below", [(1024, 16384), (512, 1000)])
def test_plan_matches_reference_on_mixed_tree(cols, dense_below):
    ref_tree, tree = _both(_tree_np())
    want = rbk.make_plan(ref_tree, cols=cols, dense_below=dense_below)
    got = bk.make_plan(tree, cols=cols, dense_below=dense_below)
    assert _fields(got) == _fields(want)


def test_plan_matches_reference_on_qwen3_smoke():
    ref_shapes = ref_build_model(ref_get_smoke_config("qwen3-4b")).param_shapes()
    shapes = build_model(get_smoke_config("qwen3-4b")).param_shapes()
    assert _fields(bk.make_plan(shapes)) == _fields(rbk.make_plan(ref_shapes))


def test_plan_of_the_main_path_config():
    """qwen3-4b at full width, 4 layers (shapes only, nothing allocated):
    the dense bucket opens with blocks.attn.k_norm, then one sparse f32
    bucket of 1154560 rows."""
    ref_shapes = ref_build_model(
        ref_get_config("qwen3-4b").replace(n_layers=4)).param_shapes()
    shapes = build_model(get_config("qwen3-4b").replace(n_layers=4)
                         ).param_shapes()
    plan = bk.make_plan(shapes)
    assert _fields(plan) == _fields(rbk.make_plan(ref_shapes))
    assert [(s.kind, s.shape) for s in plan.buckets] == [
        ("dense", (1, 24064)), ("sparse", (1154560, 1024))]
    assert plan.placements[0].shape == (4, 128)  # blocks.attn.k_norm


def test_pack_unpack_roundtrip_is_bitwise():
    tree_np = _tree_np(1)
    ref_tree, tree = _both(tree_np)
    plan = bk.make_plan(tree, cols=512)
    bufs = bk.pack(plan, tree)
    for got, want in zip(bufs, rbk.pack(rbk.make_plan(ref_tree, cols=512),
                                        ref_tree)):
        assert str(got.dtype).endswith(str(want.dtype))
        np.testing.assert_array_equal(_f32(got), _f32(want))
    out = bk.unpack(plan, bufs, cast=True)
    for a, b in zip(tree_leaves(out), tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    # without cast, unpack returns views into the buffers
    storages = {b.untyped_storage().data_ptr() for b in bufs}
    for leaf in tree_leaves(bk.unpack(plan, bufs)):
        assert leaf.untyped_storage().data_ptr() in storages


def test_bucket_memory_step_matches_reference():
    tree_np = _tree_np(2)
    ref_tree, tree = _both(tree_np)
    plan = bk.make_plan(tree, cols=512)
    rplan = rbk.make_plan(ref_tree, cols=512)
    rng = np.random.default_rng(3)
    mem_np = [rng.standard_normal(s.shape).astype(np.float32)
              for s in plan.buckets]
    k_for = lambda c: max(1, c // 64)  # noqa: E731
    applied, new_mem, n = bk.bucket_memory_step(
        plan, [torch.from_numpy(m) for m in mem_np], tree, 0.7, k_for)
    r_applied, r_mem, r_n = rbk.bucket_memory_step(
        rplan, [jnp.asarray(m) for m in mem_np], ref_tree, 0.7, k_for)
    assert n == r_n == plan.n_dispatch
    for a, b in zip(tree_leaves(applied), jax.tree.leaves(r_applied)):
        np.testing.assert_array_equal(_f32(a) != 0, _f32(b) != 0)
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=0, atol=1e-6)
    for a, b in zip(new_mem, r_mem):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=0, atol=1e-6)


def test_memsgd_bucketed_two_steps_match_reference():
    rng = np.random.default_rng(4)
    params_np = {"a": rng.standard_normal((64, 300)).astype(np.float32),
                 "c": rng.standard_normal((32,)).astype(np.float32)}
    grads_np = [jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params_np)
        for _ in range(2)]
    tx = memsgd_bucketed(0.1, constant_eta(0.05), cols=256, dense_below=64)
    rtx = ref_memsgd_bucketed(0.1, ref_constant_eta(0.05), cols=256,
                              dense_below=64)
    state = tx.init(params_from_jax(params_np))
    rstate = rtx.init(jax.tree.map(jnp.asarray, params_np))
    for g in grads_np:
        upd, state = tx.update(params_from_jax(g), state)
        rupd, rstate = rtx.update(jax.tree.map(jnp.asarray, g), rstate)
        for k in params_np:
            np.testing.assert_allclose(_f32(upd[k]), _f32(rupd[k]), rtol=0,
                                       atol=1e-6)
    assert state.count == int(rstate.count) == 2
    for a, b in zip(state.memory, rstate.memory):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=0, atol=1e-6)


def test_memsgd_bucketed_transform_converges():
    """Algorithm 1 through the bucketed engine drives a quadratic to its
    optimum (error feedback must re-inject suppressed coordinates)."""
    target = {"a": torch.ones((64, 300)), "c": torch.full((32,), 2.0)}
    w = tree_map(torch.zeros_like, target)
    tx = memsgd_bucketed(0.1, constant_eta(0.05), cols=256, dense_below=64)
    state = tx.init(w)
    assert len(state.memory) == 2  # sparse + dense bucket
    for _ in range(250):
        grads = tree_map(lambda x, t: x - t, w, target)
        updates, state = tx.update(grads, state)
        w = tree_map(lambda x, u: x + u, w, updates)
    err = max(float((w[k] - target[k]).abs().max()) for k in target)
    assert err < 1e-2, err
