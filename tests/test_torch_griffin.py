"""The port's griffin family (recurrentgemma-9b) and blocked attention
against ``repro.models`` on the CPU, and the list-aware trees they need.

Inputs are made with numpy from a seed, or are the reference's own init
carried over through numpy, and go through both packages. Tolerances:
- ``rg_lru`` (float32): rtol 1e-5, atol 1e-6. The reference's
  ``associative_scan`` (odd/even) and the port's log-depth scan
  (``linear_scan``, Hillis-Steele) combine the same terms in other
  orders, and the gates' products sum in other BLAS orders; on these
  inputs the outputs differ by at most 8.3e-7 (2.5e-7 of the largest).
  ``causal_conv`` sums its taps in the reference's order: rtol 1e-6.
  ``recurrent_block``: rtol 1e-5, atol 1e-5 (products summed in other
  orders by the two frameworks' BLAS);
- the smoke model at 3 layers (``rec, rec, attn``; the reference's smoke
  config has 2, which holds no attention layer) and seq 96, above its
  window of 64, so that the window binds: in float32 compute the loss
  within rtol 1e-5 and each gradient leaf within rtol 1e-4 and atol 1e-4
  of the leaf's largest entry, the dense family's tolerances (the scan's
  order costs nothing visible there: measured 3.7e-6 of a leaf's
  largest); in bfloat16 compute the loss within 2e-2;
- blocked attention (``_flash_full``, ``_flash_windowed``) at S = 64 with
  blocks of 16: float32 outputs rtol 1e-5, atol 1e-6 and gradients
  within 1e-5 of each input's largest; bfloat16 outputs within one bf16
  rounding (atol 1.6e-2 on outputs of |.| < 2) and gradients within 2e-2
  of each input's largest (the probabilities round to bf16 before the
  second product, and one entry's rounding can flip); ``attention`` at
  S = 3072 (tiny widths; float32): rtol 1e-5, atol 1e-5;
- trees, column axes, bucket plans, wire bytes, parameter counts, the
  conversion round trip and the per-leaf sync's selection: exact (the
  sync's values within 1e-6, as ``tests/test_torch_leaf_sync.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core import buckets as rbk
from repro.core.distributed import SyncConfig as RefSyncConfig
from repro.core.distributed import bucketed_message_bytes as ref_bucket_bytes
from repro.core.distributed import message_bytes as ref_message_bytes
from repro.core.distributed import sparse_sync_gradients as ref_leaf_sync
from repro.launch.sharding import sync_col_axes as ref_sync_col_axes
from repro.models import build_model as ref_build_model
from repro.models import griffin as RG
from repro.models import layers as RL
from repro.utils.compat import shard_map
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import buckets as bk
from repro_torch.core.distributed import (
    SyncConfig,
    bucketed_message_bytes,
    sparse_sync_gradients,
)
from repro_torch.data import token_batches
from repro_torch.launch.sharding import sync_col_axes
from repro_torch.models import build_model
from repro_torch.models import griffin as PG
from repro_torch.models import layers as L
from repro_torch.utils.tree import (
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_paths,
)

ARCH = "recurrentgemma-9b"
N_LAYERS, SEQ = 3, 96  # every block kind; above the smoke window of 64
# full width, depth cut to 3 layers as on the card: the sparse bucket and
# the bucketed paths' wire bytes per step (the reference's accounting:
# ratio 0.01, and the topk preset packed; the per-leaf path's are held in
# tests/test_torch_models.py)
FULL = dict(bucket=(2689056, 1024), bucketed=215_370_240,
            topk_packed=290_663_840)


def _cfgs(dtype="float32", n_layers=N_LAYERS):
    return (get_smoke_config(ARCH).replace(n_layers=n_layers,
                                           compute_dtype=dtype),
            ref_get_smoke_config(ARCH).replace(n_layers=n_layers,
                                               compute_dtype=dtype))


@functools.cache
def _ref_params():
    model = ref_build_model(_cfgs()[1])
    return jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def batch_np():
    return next(token_batches(512, 2, SEQ, seed=3))


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def test_tree_flatten_order_matches_jax_on_lists():
    """Dicts by sorted key, lists by index, nested either way; the leaves'
    key paths in the same order; unflatten rebuilds lists as lists;
    tree_map follows."""
    t = lambda i: torch.tensor([float(i)])  # noqa: E731
    tree = {"z": [t(0), {"b": t(1), "a": [t(2), t(3)]}], "a": t(4),
            "m": [[t(5)], [], {"y": t(6), "x": t(7)}]}
    leaves, treedef = tree_flatten(tree)
    want = jax.tree.leaves(jax.tree.map(np.asarray, tree))
    assert [float(x) for x in leaves] == [float(x[0]) for x in want]
    assert [float(x) for x in leaves] == [4, 5, 7, 6, 0, 2, 3, 1]
    jax_paths = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, tree))[0]
    assert tree_paths(tree) == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jax_paths]
    assert tree_paths(tree)[2] == ("m", 2, "x")
    back = treedef.unflatten(leaves)
    assert back["z"][1]["a"][1] is tree["z"][1]["a"][1]
    assert isinstance(back["m"], list) and back["m"][1] == []
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    doubled = tree_map(lambda x, y: x + y, tree, tree)
    assert float(doubled["m"][2]["x"]) == 14.0
    with pytest.raises(ValueError):
        treedef.flatten_up_to({**tree, "m": tree["m"][:2]})


def test_param_tree_matches_reference():
    """Same structure (blocks a list of two kinds of dict), keys, shapes
    and dtypes; the port flattens in JAX's order."""
    cfg, rcfg = _cfgs()
    assert PG.layer_kinds(cfg) == RG.layer_kinds(rcfg) == ("rec", "rec",
                                                          "attn")
    ref = ref_build_model(rcfg).param_shapes()
    got = build_model(cfg).param_shapes()
    assert isinstance(got["blocks"], list)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    leaves, _ = tree_flatten(got)
    assert all(a is b for a, b in zip(leaves, jax.tree.leaves(got)))
    for a, b in zip(leaves, jax.tree.leaves(ref)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype) == f"torch.{b.dtype}"


def test_convert_roundtrip_is_bitwise():
    params_np = _ref_params()
    back = params_to_jax(params_from_jax(params_np))
    assert jax.tree.structure(back) == jax.tree.structure(params_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_own_init_is_seeded_with_the_reference_s_distributions():
    cfg = _cfgs()[0]
    a, b = (build_model(cfg).init(seed=1, device="cpu") for _ in range(2))
    c = build_model(cfg).init(seed=2, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    # one recurrent layer at an LRU width of 1024, for the statistics
    wide = cfg.replace(n_layers=1, hybrid=dataclasses.replace(
        cfg.hybrid, lru_width=1024))
    rec = build_model(wide).init(seed=1, device="cpu")["blocks"][0]["rec"]
    # a^(1/c) = exp(-softplus(lam)) in [0.9, 0.999]
    root = torch.exp(-torch.nn.functional.softplus(rec["lam"]))
    assert rec["lam"].dtype == torch.float32
    assert 0.9 - 1e-6 <= float(root.min()) and float(root.max()) <= 0.999
    assert abs(float(rec["conv_w"].std()) - 0.5) < 0.03  # N(0, 1/W)
    assert abs(float(rec["w_a"].std()) * 32 - 1) < 0.01  # N(0, 1/R)
    assert not rec["conv_b"].any() and not rec["b_a"].any()


# ---------------------------------------------------------------------------
# the recurrent block
# ---------------------------------------------------------------------------


def _rec_params(seed):
    """One recurrent block's params of the smoke width (R = 256) as
    numpy, from the reference's init, with nonzero biases."""
    rcfg = _cfgs()[1]
    p = jax.tree.map(np.asarray, RG.init_recurrent_block(
        jax.random.PRNGKey(seed), rcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    for name in ("b_a", "b_x", "conv_b"):
        p[name] = (rng.standard_normal(p[name].shape) * 0.5).astype(
            np.float32)
    return p


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("T", [1, 7, 64, 95])
def test_linear_scan_is_the_recurrence(T):
    """The log-depth scan against the sequential recurrence (float64)."""
    rng = np.random.default_rng(T)
    a = rng.random((2, T, 5))
    b = rng.standard_normal((2, T, 5))
    h, want = np.zeros((2, 5)), []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = PG.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


def test_rg_lru_matches_reference():
    p_np = _rec_params(1)
    rng = np.random.default_rng(2)
    x, h0 = _f32(rng, 2, 40, 256), _f32(rng, 2, 256)
    y_r, h_r = RG.rg_lru(jax.tree.map(jnp.asarray, p_np), jnp.asarray(x),
                         jnp.asarray(h0))
    y, h = PG.rg_lru(params_from_jax(p_np), torch.from_numpy(x),
                     torch.from_numpy(h0))
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), rtol=1e-5,
                               atol=1e-6)


def test_causal_conv_matches_reference():
    p_np = _rec_params(3)
    rng = np.random.default_rng(4)
    x, carry = _f32(rng, 2, 33, 256), _f32(rng, 2, 3, 256)
    rp = jax.tree.map(jnp.asarray, p_np)
    pp = params_from_jax(p_np)
    for c in (carry, None):
        out_r, new_r = RG.causal_conv(
            rp, jnp.asarray(x), None if c is None else jnp.asarray(c))
        out, new = PG.causal_conv(
            pp, torch.from_numpy(x), None if c is None else torch.from_numpy(c))
        np.testing.assert_allclose(out.numpy(), np.asarray(out_r), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(new.numpy(), np.asarray(new_r))


def test_recurrent_block_matches_reference():
    rcfg = _cfgs()[1]
    p_np = _rec_params(5)
    # the block's D -> R projections at the smoke width (D = R = 256)
    rng = np.random.default_rng(6)
    x = _f32(rng, 2, 24, rcfg.d_model)
    st = {"h": _f32(rng, 2, 256), "conv": _f32(rng, 2, 3, 256)}
    out_r, st_r = RG.recurrent_block(jax.tree.map(jnp.asarray, p_np),
                                     jnp.asarray(x),
                                     jax.tree.map(jnp.asarray, st))
    out, st_p = PG.recurrent_block(params_from_jax(p_np), torch.from_numpy(x),
                                   params_from_jax(st))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), rtol=1e-5,
                               atol=1e-5)
    for name in ("h", "conv"):
        np.testing.assert_allclose(st_p[name].numpy(),
                                   np.asarray(st_r[name]), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _ref_loss_grads(dtype, params_np, batch_np):
    model = ref_build_model(_cfgs(dtype)[1])
    fn = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
    (loss, _), grads = fn(jax.tree.map(jnp.asarray, params_np),
                          {k: jnp.asarray(v) for k, v in batch_np.items()})
    return float(loss), jax.tree.leaves(jax.tree.map(np.asarray, grads))


def _port_loss_grads(dtype, params_np, batch_np):
    model = build_model(_cfgs(dtype)[0])
    leaves, treedef = tree_flatten(params_from_jax(params_np))
    live = [p.requires_grad_(True) for p in leaves]
    loss, _ = model.loss(treedef.unflatten(live),
                         {k: torch.from_numpy(v) for k, v in batch_np.items()})
    grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), [g.float().numpy() for g in grads]


def test_float32_loss_and_grads_match_reference(batch_np):
    L.ATTENTION_CALLS.clear()
    loss, grads = _port_loss_grads("float32", _ref_params(), batch_np)
    assert L.ATTENTION_CALLS == {"direct": 1}  # the one attention layer
    want_loss, want_grads = _ref_loss_grads("float32", _ref_params(),
                                            batch_np)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert len(grads) == len(want_grads)
    for g, r in zip(grads, want_grads):
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(r).max()))


def test_window_binds_at_the_test_length(batch_np):
    """Seq 96 > the smoke window of 64: a wider window changes the loss."""
    model = build_model(_cfgs()[0])
    params = params_from_jax(_ref_params())
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    logits, _ = model.forward(params, batch)
    wide, _ = model.forward(params, batch, window=SEQ)
    assert not torch.equal(logits, wide)
    # the window only reaches the last SEQ - 64 positions
    torch.testing.assert_close(logits[:, :64], wide[:, :64], rtol=0, atol=0)


def test_bfloat16_loss_matches_reference(batch_np):
    want_loss, _ = _ref_loss_grads("bfloat16", _ref_params(), batch_np)
    loss, grads = _port_loss_grads("bfloat16", _ref_params(), batch_np)
    assert abs(loss - want_loss) <= 2e-2, (loss, want_loss)
    assert all(np.isfinite(g).all() for g in grads)


# ---------------------------------------------------------------------------
# blocked attention
# ---------------------------------------------------------------------------


def _qkv_np(seed, B=2, S=64, H=4, KV=2, hd=16):
    rng = np.random.default_rng(seed)
    return _f32(rng, B, S, H, hd), _f32(rng, B, S, KV, hd), _f32(
        rng, B, S, KV, hd)


FLASH = {
    "full": (lambda q, k, v: RL._flash_full(q, k, v, 2, 16, 16),
             lambda q, k, v: L._flash_full(q, k, v, 2, 16, 16)),
    "full, kv blocks of 32": (
        lambda q, k, v: RL._flash_full(q, k, v, 2, 16, 32),
        lambda q, k, v: L._flash_full(q, k, v, 2, 16, 32)),
    "windowed": (lambda q, k, v: RL._flash_windowed(q, k, v, 2, 24, 16),
                 lambda q, k, v: L._flash_windowed(q, k, v, 2, 24, 16)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", list(FLASH))
def test_blocked_attention_matches_reference(form, dtype):
    """Outputs and the gradients of q, k and v under one cotangent."""
    ref_fn, port_fn = FLASH[form]
    arrays = _qkv_np(len(form))
    ct = np.random.default_rng(9).standard_normal(
        arrays[0].shape).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def ref_loss(*a):
        out = ref_fn(*a)
        return jnp.sum(out.astype(jnp.float32) * ct), out

    (_, out_r), g_r = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(a, jdt) for a in arrays))
    live = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in arrays]
    out = port_fn(*live)
    assert out.dtype == tdt
    g = torch.autograd.grad((out.float() * torch.from_numpy(ct)).sum(), live)
    out_r = np.asarray(out_r.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), out_r, rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(out.detach().float().numpy(), out_r,
                                   rtol=0, atol=1.6e-2)
    rel = 1e-5 if dtype == "float32" else 2e-2
    for a, b in zip(g, g_r):
        b = np.asarray(b.astype(jnp.float32))
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                   atol=rel * float(np.abs(b).max()))


def test_blocked_full_equals_direct_attention():
    """Below its threshold the causal blocked form computes the direct
    path's attention (float32 sums in another order)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv_np(3))
    direct = L._sdpa(q, k, v, L.causal_mask(64), 2)
    for qb, kvb in ((16, 16), (64, 64), (32, 16)):
        torch.testing.assert_close(L._flash_full(q, k, v, 2, qb, kvb),
                                   direct, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(L._flash_windowed(q, k, v, 2, 24, 16),
                               L._sdpa(q, k, v, L.causal_mask(64, 24), 2),
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_attention():
    """A tiny attention layer (d_model 32, 2 heads of 16, 1 kv head) from
    the reference's init, as numpy, its config in both packages."""
    cfg = get_smoke_config(ARCH).replace(d_model=32, n_heads=2,
                                         n_kv_heads=1, compute_dtype="float32")
    rcfg = ref_get_smoke_config(ARCH).replace(
        d_model=32, n_heads=2, n_kv_heads=1, compute_dtype="float32")
    p_np = jax.tree.map(np.asarray, RL.init_attention(
        jax.random.PRNGKey(4), rcfg, jnp.float32))
    return cfg, rcfg, p_np


@pytest.mark.parametrize("window,branch", [(None, "flash_full"),
                                           (1000, "flash_windowed"),
                                           (4096, "flash_full")])
def test_attention_dispatch_above_the_threshold(tiny_attention, window,
                                                branch):
    """``attention`` at S = 3072 > 2048: blocks of 1024, the windowed form
    where the window is shorter than S, the causal form otherwise."""
    cfg, rcfg, p_np = tiny_attention
    S = 3072
    rng = np.random.default_rng(5)
    x = _f32(rng, 1, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (1, S))
    want = RL.attention(jax.tree.map(jnp.asarray, p_np), rcfg,
                        jnp.asarray(x), jnp.asarray(pos), window)
    L.ATTENTION_CALLS.clear()
    got = L.attention(params_from_jax(p_np), cfg, torch.from_numpy(x),
                      torch.from_numpy(pos.copy()), window)
    assert L.ATTENTION_CALLS == {branch: 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_long_sequences_off_the_block_raise_by_name(tiny_attention):
    cfg, _, p_np = tiny_attention
    x = torch.zeros((1, 2049, cfg.d_model))
    pos = torch.zeros((1, 2049), dtype=torch.int32)
    for window in (None, 512):
        with pytest.raises(ValueError, match="multiple of its q_block"):
            L.attention(params_from_jax(p_np), cfg, x, pos, window)
    q, k, v = (torch.from_numpy(a) for a in _qkv_np(0))
    with pytest.raises(ValueError, match="kv_block of 24"):
        L._flash_full(q, k, v, 2, 16, 24)


# ---------------------------------------------------------------------------
# sync: column axes, buckets, bytes
# ---------------------------------------------------------------------------


def _shapes(full: bool):
    get, ref_get = ((get_config, ref_get_config) if full
                    else (get_smoke_config, ref_get_smoke_config))
    return (build_model(get(ARCH).replace(n_layers=3)).param_shapes(),
            ref_build_model(ref_get(ARCH).replace(n_layers=3)).param_shapes())


def _fields(plan):
    return ([dataclasses.astuple(s) for s in plan.buckets],
            [dataclasses.astuple(p) for p in plan.placements])


@pytest.mark.parametrize("full", [False, True])
def test_col_axes_and_bucket_plan_match_reference(full):
    shapes, ref_shapes = _shapes(full)
    cols = sync_col_axes(shapes)
    assert cols == jax.tree.map(int, ref_sync_col_axes(ref_shapes))
    assert cols["blocks"][0]["rec"]["conv_w"] == 0  # rows of C = 4
    for kw in (dict(), dict(cols=512, dense_below=1000)):
        assert _fields(bk.make_plan(shapes, **kw)) == _fields(
            rbk.make_plan(ref_shapes, **kw))
    if full:
        sparse = [s for s in bk.make_plan(shapes).buckets
                  if s.kind == "sparse"]
        assert [(s.rows, s.cols) for s in sparse] == [FULL["bucket"]]
        assert sparse[0].rows * sparse[0].cols > 2**31


def test_full_width_bucketed_wire_bytes_match_reference():
    """Shapes only, nothing allocated: the figures the card's runs check."""
    shapes, ref_shapes = _shapes(True)
    plan, ref_plan = bk.make_plan(shapes), rbk.make_plan(ref_shapes)
    for sync, ref_sync, key in (
            (SyncConfig(ratio=0.01, bucketed=True),
             RefSyncConfig(ratio=0.01, bucketed=True), "bucketed"),
            (SyncConfig.preset("topk", ratio=0.02),
             RefSyncConfig.preset("topk", ratio=0.02), "topk_packed")):
        assert bucketed_message_bytes(sync, plan) == int(ref_bucket_bytes(
            ref_sync, ref_plan)) == FULL[key]


def test_per_leaf_sync_takes_conv_w_s_rows_of_four():
    """The smoke config's per-leaf sync with ``dense_below`` lowered to
    1024, so that each (4, 256) ``conv_w`` selects its 256 rows of C = 4
    (k = 1): the port's against the reference's inside a 1-device
    shard_map, leaf for leaf."""
    shapes, ref_shapes = _shapes(False)
    cols = sync_col_axes(shapes)
    rng = np.random.default_rng(8)
    mem_np, grads_np = (jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        ref_shapes) for _ in range(2))
    cfg = SyncConfig(ratio=0.01, dense_below=1024)
    upd, mem, nbytes = sparse_sync_gradients(
        cfg, params_from_jax(mem_np), params_from_jax(grads_np), 0.3, cols)
    rcfg = RefSyncConfig(ratio=0.01, dense_below=1024)
    ref_cols = ref_sync_col_axes(ref_shapes)

    def body(m, g):
        return ref_leaf_sync(rcfg, m, g, jnp.float32(0.3), ref_cols)[:2]

    spec = jax.tree.map(lambda _: P(), ref_shapes)
    r_upd, r_mem = jax.jit(shard_map(
        body, mesh=jax.make_mesh((1,), ("data",)), in_specs=(spec, spec),
        out_specs=(spec, spec)))(jax.tree.map(jnp.asarray, mem_np),
                                 jax.tree.map(jnp.asarray, grads_np))
    assert nbytes == ref_message_bytes(rcfg, ref_shapes, ref_cols)
    conv = upd["blocks"][1]["rec"]["conv_w"]
    assert tuple(conv.shape) == (4, 256)
    assert ((conv != 0).sum(dim=0) == 1).all()  # one of each row of 4
    for a, b in zip(tree_leaves(upd), jax.tree.leaves(r_upd)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(a != 0, b != 0)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in zip(tree_leaves(mem), jax.tree.leaves(r_mem)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
