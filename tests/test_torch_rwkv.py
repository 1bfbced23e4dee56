"""The port's RWKV-6 family against ``repro.models.rwkv`` on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Tolerances:
- the WKV recurrence (chunked, per step and the pure-scan fallback):
  atol/rtol 5e-5, as ``tests/test_recurrent_models.py`` holds the
  reference's chunked form against its own per-step form (float32 sums
  taken in other orders);
- ``groupnorm_heads``: rtol 1e-5, atol 1e-6 (float32 statistics);
- the WKV's gradients: within 1e-5 of each input's largest, rtol 5e-5
  (they agree to 3e-6 of it);
- the smoke model from the reference's init carried over through numpy:
  in float32 compute the loss within rtol 1e-5 and each gradient leaf
  within rtol 1e-4 and atol 2e-4 of the leaf's largest entry. The dense
  family's test holds atol 1e-4, but the float32 gradients of this model
  are ill-conditioned and 1e-4 is below the reference's own error: held
  against a float64 evaluation of the same model, the reference's lie up
  to 1.25e-4 of a leaf's largest entry from it and the port's up to
  2.66e-4 (``mix_w1``, ``mu_base``, ``mu``), 1.45e-4 apart. The rounding
  of the matrix products alone costs 1.05e-4 there, the WKV in float32
  alone 5e-6; a literal per-chunk port of the reference's scan gives the
  port's error unchanged, and with every product rounded from float64 it
  is 1.09e-4: the port's excess on this batch is the CPU BLAS, which
  rounds the smoke model's narrow LoRA products (N = 8, 20) 2.4-2.9x
  worse than XLA's (``tools/rwkv_grad_precision.py`` measures all of
  these; PERF.md gives them for other batches). In the default bfloat16
  compute the loss within 2e-2 (bf16 rounds at other places in the two
  frameworks);
- parameter trees, column axes, bucket plans, wire bytes and the
  ``convert.py`` round trip: exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core import buckets as rbk
from repro.core.distributed import SyncConfig as RefSyncConfig
from repro.core.distributed import bucketed_message_bytes as ref_bucket_bytes
from repro.core.distributed import message_bytes as ref_message_bytes
from repro.launch.sharding import sync_col_axes as ref_sync_col_axes
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.models import rwkv as RW
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import buckets as bk
from repro_torch.core.distributed import (
    SyncConfig,
    bucketed_message_bytes,
    message_bytes,
)
from repro_torch.data import token_batches
from repro_torch.launch.sharding import sync_col_axes
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import rwkv as PW
from repro_torch.utils.tree import tree_flatten, tree_leaves

ARCH = "rwkv6-3b"
TOL = dict(atol=5e-5, rtol=5e-5)


def _wkv_inputs(B, T, H, n, seed):
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v = f32(B, T, H, n), f32(B, T, H, n), f32(B, T, H, n)
    # log-decay in (-DECAY_CLAMP, 0), as _decay_log gives it
    log_w = (-RW.DECAY_CLAMP / (1.0 + np.exp(-f32(B, T, H, n)))).astype(
        np.float32)
    bonus = f32(H, n) * 0.1
    state = f32(B, H, n, n)  # a nonzero initial state
    return r, k, v, log_w, bonus, state


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_wkv_chunked_matches_reference(chunk):
    ref_in, port_in = _both(_wkv_inputs(2, 64, 3, 8, seed=chunk))
    o_r, S_r = RW.wkv_chunked(*ref_in, chunk)
    o_p, S_p = PW.wkv_chunked(*port_in, chunk)
    assert o_p.dtype == torch.float32 and S_p.dtype == torch.float32
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_r), **TOL)
    np.testing.assert_allclose(S_p.numpy(), np.asarray(S_r), **TOL)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_wkv_chunked_grads_match_reference(chunk):
    """The gradients of the chunked form (the port's batched chunks and
    its state carry against the reference's scan) for every input, under
    one cotangent on o and the final state: within 1e-5 of each input's
    largest gradient, rtol 5e-5."""
    arrays = _wkv_inputs(2, 64, 3, 8, seed=chunk)
    rng = np.random.default_rng(100 + chunk)
    ct_o = rng.standard_normal((2, 64, 3, 8)).astype(np.float32)
    ct_s = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)

    def ref_loss(*a):
        o, S = RW.wkv_chunked(*a, chunk)
        return jnp.sum(o * ct_o) + jnp.sum(S * ct_s)

    want = jax.grad(ref_loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in arrays))
    live = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    o, S = PW.wkv_chunked(*live, chunk)
    got = torch.autograd.grad(
        (o * torch.from_numpy(ct_o)).sum() + (S * torch.from_numpy(ct_s)).sum(),
        live)
    for g, r in zip(got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=5e-5,
                                   atol=1e-5 * float(np.abs(r).max()))


def test_wkv_step_and_scan_fallback_match_reference():
    """T = 40 is no whole number of 16-token chunks: the pure scan of
    ``wkv_step``, as the reference's time_mix falls back to."""
    ref_in, port_in = _both(_wkv_inputs(2, 40, 3, 8, seed=40))
    r, k, v, log_w, bonus, S = ref_in
    outs = []
    for t in range(40):
        o, S = RW.wkv_step(r[:, t], k[:, t], v[:, t], log_w[:, t], bonus, S)
        outs.append(o)
    o_p, S_p = PW.wkv_scan(*port_in)
    np.testing.assert_allclose(o_p.numpy(), np.asarray(jnp.stack(outs, 1)),
                               **TOL)
    np.testing.assert_allclose(S_p.numpy(), np.asarray(S), **TOL)
    o1, S1 = PW.wkv_step(*(a[:, 0] for a in port_in[:4]), *port_in[4:])
    o1_r, S1_r = RW.wkv_step(*(a[:, 0] for a in ref_in[:4]), *ref_in[4:])
    np.testing.assert_allclose(o1.numpy(), np.asarray(o1_r), **TOL)
    np.testing.assert_allclose(S1.numpy(), np.asarray(S1_r), **TOL)


def test_time_mix_takes_the_fallback_as_the_reference_does():
    """A whole layer's time mix at T = 40 (the scan) and T = 32 (two
    chunks), float32, from the reference's init."""
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    rcfg = ref_get_smoke_config(ARCH).replace(compute_dtype="float32")
    p_np = jax.tree.map(
        lambda a: np.asarray(a)[0],
        ref_build_model(rcfg).init(jax.random.PRNGKey(1))["blocks"]["time"])
    p = params_from_jax(p_np)
    rng = np.random.default_rng(5)
    H, n = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    for T in (40, 32):
        x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
        last = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
        S0 = rng.standard_normal((2, H, n, n)).astype(np.float32) * 0.1
        got = PW.time_mix(p, cfg, torch.from_numpy(x), torch.from_numpy(last),
                          torch.from_numpy(S0))
        want = RW.time_mix(jax.tree.map(jnp.asarray, p_np), rcfg,
                           jnp.asarray(x), jnp.asarray(last), jnp.asarray(S0))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4)


def test_groupnorm_heads_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 16, 4, 64)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal((4, 64)).astype(np.float32)
    want = RL.groupnorm_heads(jnp.asarray(scale), jnp.asarray(x))
    got = L.groupnorm_heads(torch.from_numpy(scale), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert L.groupnorm_heads(torch.from_numpy(scale), xb).dtype == \
        torch.bfloat16


@pytest.fixture(scope="module")
def params_np():
    model = ref_build_model(ref_get_smoke_config(ARCH))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def batch_np():
    return next(token_batches(512, 2, 32, seed=3))


def test_param_tree_matches_reference():
    """Same keys, shapes and dtypes (24 leaves); the port flattens in
    JAX's order."""
    ref = ref_build_model(ref_get_smoke_config(ARCH)).param_shapes()
    got = build_model(get_smoke_config(ARCH)).param_shapes()
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    leaves, _ = tree_flatten(got)
    assert len(leaves) == 24
    for a, b in zip(leaves, jax.tree.leaves(ref)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype) == f"torch.{b.dtype}"


def test_own_init_has_the_reference_constants():
    p = build_model(get_smoke_config(ARCH)).init(seed=0, device="cpu")
    t = p["blocks"]["time"]
    for name, value in (("mu_base", 0.5), ("mu", 0.5), ("w0", 0.0),
                        ("bonus", 0.0), ("gn", 1.0)):
        assert torch.all(t[name] == value), name
    R = get_smoke_config(ARCH).rwkv.lora_rank_mix
    assert abs(float(t["mix_w2"].std()) * R ** 0.5 - 1.0) < 0.1
    q = build_model(get_smoke_config(ARCH)).init(seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                  tree_leaves(q)))


def test_convert_roundtrip_is_bitwise(params_np):
    back = params_to_jax(params_from_jax(params_np))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _ref_loss_grads(dtype, params_np, batch_np):
    model = ref_build_model(
        ref_get_smoke_config(ARCH).replace(compute_dtype=dtype))
    fn = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
    (loss, _), grads = fn(jax.tree.map(jnp.asarray, params_np),
                          {k: jnp.asarray(v) for k, v in batch_np.items()})
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_grads(dtype, params_np, batch_np):
    model = build_model(get_smoke_config(ARCH).replace(compute_dtype=dtype))
    leaves, treedef = tree_flatten(params_from_jax(params_np))
    live = [p.requires_grad_(True) for p in leaves]
    loss, _ = model.loss(treedef.unflatten(live),
                         {k: torch.from_numpy(v) for k, v in batch_np.items()})
    grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), [g.numpy() for g in grads]


def test_float32_loss_and_grads_match_reference(params_np, batch_np):
    want_loss, want_grads = _ref_loss_grads("float32", params_np, batch_np)
    loss, grads = _port_loss_grads("float32", params_np, batch_np)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for g, r in zip(grads, jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=2e-4 * float(np.abs(r).max()))


def test_bfloat16_loss_matches_reference(params_np, batch_np):
    want_loss, _ = _ref_loss_grads("bfloat16", params_np, batch_np)
    loss, grads = _port_loss_grads("bfloat16", params_np, batch_np)
    assert abs(loss - want_loss) <= 2e-2, (loss, want_loss)
    assert all(np.isfinite(g).all() for g in grads)


def _fields(plan):
    return ([dataclasses.astuple(s) for s in plan.buckets],
            [dataclasses.astuple(p) for p in plan.placements])


def _ref_sync(cfg):
    """The reference's config of an unpacked-wire port config."""
    assert cfg.wire == "unpacked"
    return RefSyncConfig(ratio=cfg.ratio, strategy=cfg.strategy,
                         bucketed=cfg.bucketed)


def test_col_axes_and_plan_match_reference_on_the_smoke_config():
    ref_shapes = ref_build_model(ref_get_smoke_config(ARCH)).param_shapes()
    shapes = build_model(get_smoke_config(ARCH)).param_shapes()
    assert sync_col_axes(shapes) == jax.tree.map(
        int, ref_sync_col_axes(ref_shapes))
    plan = bk.make_plan(shapes)
    assert _fields(plan) == _fields(rbk.make_plan(ref_shapes))
    assert len(plan.placements) == 24 and len(plan.buckets) == 2


def test_full_width_layout_and_bytes_match_reference():
    """rwkv6-3b at full width, depth cut to 8 (shapes only, nothing
    allocated): the buckets, the per-leaf column axes and every path's
    bytes per step equal the reference's, and the figures the card's
    run checks."""
    shapes = build_model(get_config(ARCH).replace(n_layers=8)).param_shapes()
    ref_shapes = ref_build_model(
        ref_get_config(ARCH).replace(n_layers=8)).param_shapes()
    cols = sync_col_axes(shapes)
    ref_cols = ref_sync_col_axes(ref_shapes)
    assert cols == jax.tree.map(int, ref_cols)
    plan = bk.make_plan(shapes)
    ref_plan = rbk.make_plan(ref_shapes)
    assert _fields(plan) == _fields(ref_plan)
    assert [(s.kind, s.shape) for s in plan.buckets] == [
        ("sparse", (1002500, 1024)), ("dense", (1, 2560))]
    topk = SyncConfig.preset("topk", ratio=0.02)
    cases = [
        (topk, bucketed_message_bytes(topk, plan),
         ref_bucket_bytes(RefSyncConfig.preset("topk", ratio=0.02),
                          ref_plan), 108_280_272),
        (None, bucketed_message_bytes(
            dataclasses.replace(topk, wire="unpacked"), plan),
         ref_bucket_bytes(RefSyncConfig.preset("topk", ratio=0.02,
                                               wire="unpacked"), ref_plan),
         160_410_240),
    ]
    bucketed = SyncConfig(ratio=0.01, bucketed=True)
    cases.append((bucketed, bucketed_message_bytes(bucketed, plan),
                  ref_bucket_bytes(_ref_sync(bucketed), ref_plan),
                  80_210_240))
    leaf = SyncConfig(ratio=0.01)
    cases.append((leaf, message_bytes(leaf, shapes, cols),
                  ref_message_bytes(_ref_sync(leaf), ref_shapes, ref_cols),
                  83_927_936))
    dense = SyncConfig(strategy="dense")
    cases.append((dense, message_bytes(dense, shapes, cols),
                  ref_message_bytes(_ref_sync(dense), ref_shapes, ref_cols),
                  4_106_250_240))
    for _, got, want, figure in cases:
        assert got == int(want) == figure
