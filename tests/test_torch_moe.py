"""The port's MoE layer against ``repro.models.moe`` on the CPU.

Parameters and inputs are made with numpy from a seed and go through both
packages in float32, on both MoE smoke configs (granite-moe-3b-a800m,
qwen3-moe-30b-a3b: E = 4 experts, top-2). Tolerances:
- routing (``top_i``), the capacity mask (``keep``) and the slots: equal,
  asserted before any output is compared;
- ``moe_ffn``'s output within rtol 1e-5 and atol 1e-5 of its largest
  entry (float32 products summed in other orders), its aux loss within
  rtol 1e-5;
- the reference's own invariants, ported to torch, under its own
  tolerances: the scatter dispatch equals the dense-dispatch oracle at
  capacity factor 8 (atol/rtol 1e-4), and at capacity factor 1.0 the
  drops move the output by less than half its norm;
- parameter and memory conversion of the 4-D expert leaves, column axes,
  bucket plans and wire bytes at full width: exact.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core import buckets as rbk
from repro.core.distributed import SyncConfig as RefSyncConfig
from repro.core.distributed import bucketed_message_bytes as ref_bucket_bytes
from repro.core.distributed import message_bytes as ref_message_bytes
from repro.launch.sharding import sync_col_axes as ref_sync_col_axes
from repro.models import build_model as ref_build_model
from repro.models import moe as RM
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import (
    memory_from_jax,
    memory_to_jax,
    params_from_jax,
    params_to_jax,
)
from repro_torch.core import buckets as bk
from repro_torch.core.distributed import (
    SyncConfig,
    bucketed_message_bytes,
    message_bytes,
)
from repro_torch.launch.sharding import sync_col_axes
from repro_torch.models import build_model
from repro_torch.models import moe as M

ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")
# the reference's layer, compiled once per config and shape
ref_route = jax.jit(RM._route, static_argnums=1)
ref_moe_ffn = jax.jit(RM.moe_ffn, static_argnums=(1, 3))


def _params_np(cfg, seed):
    """One layer's MoE leaves in the reference's layout, made with numpy:
    the init's scales (router N(0, 1/D), experts N(0, 1/d_in))."""
    rng = np.random.default_rng(seed)
    m = cfg.moe
    E, D, Fe = m.n_experts, cfg.d_model, m.d_expert

    def normal(shape, d_in):
        return (rng.standard_normal(shape) / math.sqrt(d_in)).astype(
            np.float32)

    return {"router": normal((D, E), D), "w_gate": normal((E, D, Fe), D),
            "w_up": normal((E, D, Fe), D), "w_down": normal((E, Fe, D), Fe)}


def _x_np(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def _ref_keep_slot(top_i, n_experts, C):
    """The reference's capacity mask and slots (``moe.py:73-78``) in
    numpy, from its routing."""
    N, G, K = top_i.shape
    onehot = np.eye(n_experts, dtype=np.int32)[top_i.reshape(N, G * K)]
    pos = np.cumsum(onehot, axis=1) - onehot
    pos_in_e = np.sum(pos * onehot, axis=-1).reshape(N, G, K)
    keep = pos_in_e < C
    return keep, np.where(keep, pos_in_e, 0)


def _routing(arch, p_np, x_np, capacity_factor):
    """Both packages' routing of grouped tokens x (N, G, D): asserts equal
    top_i, keep and slots; returns keep."""
    cfg = get_smoke_config(arch)
    N, G, _ = x_np.shape
    C = M.capacity(G, cfg, capacity_factor)
    assert C == max(1, math.ceil(G * cfg.moe.top_k * capacity_factor
                                 / cfg.moe.n_experts))
    _, r_top_i, _ = ref_route(jax.tree.map(jnp.asarray, p_np),
                              ref_get_smoke_config(arch), jnp.asarray(x_np))
    r_keep, r_slot = _ref_keep_slot(np.asarray(r_top_i), cfg.moe.n_experts,
                                    C)
    _, top_i, _ = M.route(params_from_jax(p_np), cfg, torch.from_numpy(x_np))
    keep, slot = M.assign_slots(top_i, cfg.moe.n_experts, C)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(r_top_i))
    np.testing.assert_array_equal(keep.numpy(), r_keep)
    np.testing.assert_array_equal(slot.numpy(), r_slot)
    return keep.numpy()


@pytest.mark.parametrize("S", [16, 1])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, capacity_factor, S):
    """moe_ffn on (B, S, D): per-sequence groups for S > 1, the whole
    batch as one group for S == 1. At capacity factor 1.25 some tokens
    drop, at 8.0 none do."""
    cfg = get_smoke_config(arch)
    p_np = _params_np(cfg, 0)
    B = 8 if S == 1 else 2
    x_np = _x_np(cfg, (B, S), 1)
    grouped = x_np.reshape(1, B, -1) if S == 1 else x_np
    keep = _routing(arch, p_np, grouped, capacity_factor)
    assert keep.all() == (capacity_factor == 8.0)

    want, r_aux = ref_moe_ffn(jax.tree.map(jnp.asarray, p_np),
                              ref_get_smoke_config(arch), jnp.asarray(x_np),
                              capacity_factor)
    got, aux = M.moe_ffn(params_from_jax(p_np), cfg, torch.from_numpy(x_np),
                         capacity_factor)
    want = np.asarray(want)
    assert got.shape == want.shape == x_np.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-5)


def test_router_ties_go_to_the_lowest_expert():
    """Equal probabilities: the lowest indices first, in order, as
    ``jax.lax.top_k``; also on tie-heavy rows against it."""
    _, idx = M.router_top_k(torch.full((3, 8), 0.125), 2)
    assert idx.tolist() == [[0, 1]] * 3
    _, idx = M.router_top_k(torch.full((2, 40), 1 / 40), 8)
    assert idx.tolist() == [list(range(8))] * 2
    rng = np.random.default_rng(5)
    probs = (rng.integers(0, 4, (64, 40)) / 4).astype(np.float32)
    r_vals, r_idx = jax.lax.top_k(jnp.asarray(probs), 8)
    vals, idx = M.router_top_k(torch.from_numpy(probs), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_routes_as_the_reference(arch):
    """A zero router makes every probability 1/E: every token goes to
    experts 0 and 1 in that order, the capacity drops the same tokens as
    the reference's, and the aux loss is its minimum, the weight."""
    cfg = get_smoke_config(arch)
    p_np = dict(_params_np(cfg, 0))
    p_np["router"] = np.zeros_like(p_np["router"])
    x_np = _x_np(cfg, (2, 64), 4)
    keep = _routing(arch, p_np, x_np, 1.25)
    assert not keep.all()
    _, top_i, _ = M.route(params_from_jax(p_np), cfg, torch.from_numpy(x_np))
    assert (top_i.numpy() == np.arange(cfg.moe.top_k)).all()
    want, r_aux = ref_moe_ffn(jax.tree.map(jnp.asarray, p_np),
                              ref_get_smoke_config(arch), jnp.asarray(x_np))
    got, aux = M.moe_ffn(params_from_jax(p_np), cfg, torch.from_numpy(x_np))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-5)
    np.testing.assert_allclose(float(aux), cfg.moe.aux_loss_weight,
                               rtol=1e-3)


def _dense_dispatch_oracle(p, cfg, x):
    """All experts for all tokens (exact, no capacity drops): the
    reference test's oracle in torch."""
    m = cfg.moe
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    top_w, top_i = M.router_top_k(probs, m.top_k)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    h = torch.einsum("bsd,edf->ebsf", x, p["w_gate"])
    u = torch.einsum("bsd,edf->ebsf", x, p["w_up"])
    y = torch.einsum("ebsf,efd->ebsd", F.silu(h) * u, p["w_down"])
    y = y.movedim(0, -2)  # (B, S, E, D)
    out = torch.zeros_like(x)
    for kk in range(m.top_k):
        sel = torch.gather(y, 2, top_i[:, :, kk, None, None].expand(
            -1, -1, 1, y.shape[-1]))[:, :, 0]
        out = out + sel * top_w[:, :, kk, None]
    return out


def test_capacity_dispatch_matches_oracle_at_high_capacity():
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    p = params_from_jax(_params_np(cfg, 0))
    x = torch.from_numpy(_x_np(cfg, (2, 16), 1))
    got, _ = M.moe_ffn(p, cfg, x, capacity_factor=8.0)
    np.testing.assert_allclose(got.numpy(),
                               _dense_dispatch_oracle(p, cfg, x).numpy(),
                               atol=1e-4, rtol=1e-4)


def test_capacity_drops_bounded():
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    p = params_from_jax(_params_np(cfg, 0))
    x = torch.from_numpy(_x_np(cfg, (2, 32), 2))
    got, _ = M.moe_ffn(p, cfg, x, capacity_factor=1.0)
    want = _dense_dispatch_oracle(p, cfg, x)
    assert not torch.equal(got, want)  # some tokens dropped
    assert float((got - want).norm() / want.norm()) < 0.5


def test_moe_grads_flow_to_router_and_experts():
    cfg = get_smoke_config("granite-moe-3b-a800m")
    p = {k: v.requires_grad_(True)
         for k, v in params_from_jax(_params_np(cfg, 0)).items()}
    out, aux = M.moe_ffn(p, cfg, torch.from_numpy(_x_np(cfg, (1, 8), 5)))
    grads = torch.autograd.grad(torch.sum(out ** 2) + aux, list(p.values()))
    assert all(float(g.norm()) > 0 for g in grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_leaves_convert_leafwise(arch):
    """The reference's init and a per-leaf memory (leading worker axis)
    carry the 4-D expert leaves across bit for bit and back."""
    rmodel = ref_build_model(ref_get_smoke_config(arch))
    params_np = jax.tree.map(np.asarray,
                             jax.jit(rmodel.init)(jax.random.PRNGKey(0)))
    params = params_from_jax(params_np)
    cfg = get_smoke_config(arch)
    m = cfg.moe
    L, D = cfg.n_layers, cfg.d_model
    moe = params["blocks"]["moe"]
    assert {k: tuple(v.shape) for k, v in moe.items()} == {
        "router": (L, D, m.n_experts),
        "w_gate": (L, m.n_experts, D, m.d_expert),
        "w_up": (L, m.n_experts, D, m.d_expert),
        "w_down": (L, m.n_experts, m.d_expert, D)}
    for a, b in zip(jax.tree.leaves(params_to_jax(params)),
                    jax.tree.leaves(params_np)):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    rng = np.random.default_rng(6)
    memory_np = jax.tree.map(
        lambda a: rng.standard_normal((1,) + a.shape).astype(np.float32),
        params_np)
    memory = memory_from_jax(memory_np)
    assert tuple(memory["blocks"]["moe"]["w_down"].shape) == \
        memory_np["blocks"]["moe"]["w_down"].shape[1:]
    for a, b in zip(jax.tree.leaves(memory_to_jax(memory)),
                    jax.tree.leaves(memory_np)):
        np.testing.assert_array_equal(a, b)


def _fields(plan):
    return ([dataclasses.astuple(s) for s in plan.buckets],
            [dataclasses.astuple(p) for p in plan.placements])


# full width, depth cut as on the card: (layers, sparse bucket, the
# parameters, bytes per step: per-leaf, bucketed, topk packed, unpacked)
FULL_WIDTH = {
    "granite-moe-3b-a800m": (8, (935136, 1024), 957_605_376,
                             (74_975_232, 74_915_328, 101_099_168,
                              149_726_208)),
    "qwen3-moe-30b-a3b": (2, (1825280, 1024), 1_869_097_472,
                          (150_251_520, 146_065_408, 197_173_280,
                           292_087_808)),
}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_layout_and_bytes_match_reference(arch):
    """At full width, depth cut (shapes only, nothing allocated): the
    parameter count, the buckets, the per-leaf column axes and every
    path's bytes per step equal the reference's and the figures the
    card's run checks."""
    n_layers, bucket, n_params, figures = FULL_WIDTH[arch]
    model = build_model(get_config(arch).replace(n_layers=n_layers))
    rmodel = ref_build_model(ref_get_config(arch).replace(n_layers=n_layers))
    shapes, ref_shapes = model.param_shapes(), rmodel.param_shapes()
    assert model.n_params() == rmodel.n_params() == n_params
    assert model.n_active_params() == rmodel.n_active_params()
    cols = sync_col_axes(shapes)
    ref_cols = ref_sync_col_axes(ref_shapes)
    assert cols == jax.tree.map(int, ref_cols)
    plan, ref_plan = bk.make_plan(shapes), rbk.make_plan(ref_shapes)
    assert _fields(plan) == _fields(ref_plan)
    assert [s.shape for s in plan.buckets if s.kind == "sparse"] == [bucket]
    leaf = SyncConfig(ratio=0.01)
    bucketed = SyncConfig(ratio=0.01, bucketed=True)
    got = (message_bytes(leaf, shapes, cols),
           bucketed_message_bytes(bucketed, plan),
           bucketed_message_bytes(SyncConfig.preset("topk", ratio=0.02),
                                  plan),
           bucketed_message_bytes(
               SyncConfig.preset("topk", ratio=0.02, wire="unpacked"), plan))
    want = (ref_message_bytes(RefSyncConfig(ratio=0.01), ref_shapes,
                              ref_cols),
            ref_bucket_bytes(RefSyncConfig(ratio=0.01, bucketed=True),
                             ref_plan),
            ref_bucket_bytes(RefSyncConfig.preset("topk", ratio=0.02),
                             ref_plan),
            ref_bucket_bytes(RefSyncConfig.preset("topk", ratio=0.02,
                                                  wire="unpacked"),
                             ref_plan))
    assert got == tuple(int(x) for x in want) == figures
