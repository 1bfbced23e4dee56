"""The two-level pod sync's host-side pieces against the reference's, on
the same numpy inputs in one process: the pod-k helpers and their raises,
``validate``'s pod, repack and budget errors, ``mask_live_k``, the three
capture helpers (within 1e-6), the autotune and both ``BudgetController``
modes (equal ks, on per-shard stacks and on global buffers, with k caps),
the repack codec (bit for bit the reference's compacted buffer, realized
bytes equal to the accounted ones) and the byte accounting by level
(static, padded and effective).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MESHES as REF_MESHES
from repro.configs import PodRefreshConfig as RefPodRefreshConfig
from repro.core import buckets as rbk
from repro.core import encoding as renc
from repro.core.budget import BudgetController as RefBudgetController
from repro.core.distributed import SyncConfig as RefSyncConfig
from repro.core.distributed import autotune_pod_ratios as ref_autotune
from repro.core.distributed import bucketed_message_bytes as ref_bucket_bytes
from repro.core.distributed import message_bytes as ref_message_bytes
from repro.core.distributed import repack_transport as ref_transport
from repro.core.distributed import validate_pod_ratios as ref_validate_ratios
from repro.core.pipeline import EmulatedLink as RefLink
from repro.kernels.topk_select import mask_live_k as ref_mask_live_k
from repro_torch.configs import MESHES, PodRefreshConfig
from repro_torch.core import buckets as bk
from repro_torch.core import encoding as enc
from repro_torch.core.budget import BudgetController
from repro_torch.core.distributed import (
    SyncConfig,
    autotune_pod_ratios,
    bucketed_message_bytes,
    message_bytes,
    repack_transport,
    validate_pod_ratios,
)
from repro_torch.core.pipeline import EmulatedLink
from repro_torch.kernels.ref import row_topk_ref
from repro_torch.kernels.topk_select import mask_live_k

N_DATA = 4
COLS = 128


def _ref(cfg: SyncConfig) -> RefSyncConfig:
    """The reference's config with the port's field values, its pod, wire
    and transport groups field for field."""
    from repro.core import distributed as rd

    groups = {"pod": rd.PodConfig, "wire_cfg": rd.WireConfig,
              "transport": rd.TransportConfig}
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in groups.items():
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return RefSyncConfig(**kw)


def _hier(**kw) -> SyncConfig:
    kw.setdefault("strategy", "hierarchical")
    kw.setdefault("ratio", 0.05)
    kw.setdefault("wire", "packed")
    return SyncConfig(bucketed=True, bucket_cols=COLS, pod_axis="pod", **kw)


def _tree(dtype_h=jnp.bfloat16):
    """Three buckets: a float32 sparse, a bf16 sparse and a dense one."""
    return {"w": jnp.zeros((16, 384)), "h": jnp.zeros((24, 256), dtype_h),
            "b": jnp.zeros((40,))}


def _plans():
    tree = _tree()
    rplan = rbk.make_plan(tree, cols=COLS, dense_below=64)
    plan = bk.make_plan({k: torch.zeros(v.shape, dtype=getattr(
        torch, str(v.dtype))) for k, v in tree.items()}, cols=COLS,
        dense_below=64)
    assert [dataclasses.astuple(s) for s in plan.buckets] == [
        dataclasses.astuple(s) for s in rplan.buckets]
    return plan, rplan


def _bufs(plan, seed, shards=None, heavy=()):
    """numpy u buffers per bucket: (rows, cols) or (shards, rows, cols);
    buckets in ``heavy`` scaled by 30, so that the water-fill has a
    preference. Correlated shards (a shared part), as gradients are."""
    rng = np.random.default_rng(seed)
    out = []
    for b, spec in enumerate(plan.buckets):
        shape = (spec.rows, spec.cols)
        base = rng.standard_normal(shape).astype(np.float32)
        # a heavy tail: a few large entries per row
        base *= np.where(rng.random(shape) < 0.05, 8.0, 1.0).astype(
            np.float32)
        if shards is not None:
            base = base + rng.standard_normal(
                (shards,) + shape).astype(np.float32)
        out.append((base * (30.0 if b in heavy else 1.0)).astype(
            np.float32))
    return out


# -- pod-k helpers --------------------------------------------------------


@pytest.mark.parametrize("ratio,pod_ratio,k_min,k_max,k_max_ratio", [
    (0.02, None, 1, None, None), (0.02, 0.01, 1, None, None),
    (0.01, 0.05, 3, None, 0.02), (0.05, 0.2, 1, 16, None),
    (0.001, None, 2, None, 0.5)])
def test_pod_k_helpers_match_reference(ratio, pod_ratio, k_min, k_max,
                                       k_max_ratio):
    for ratios in (None, (1.0, 0.03, 0.3)):
        cfg = SyncConfig(strategy="hierarchical", ratio=ratio, k_min=k_min,
                         k_max=k_max, pod_ratio=pod_ratio, pod_ratios=ratios,
                         pod_k_max_ratio=k_max_ratio, pod_axis="pod")
        rcfg = _ref(cfg)
        for cols in (4, 64, 128, 1000, 4096):
            assert cfg.pod_k_for(cols) == rcfg.pod_k_for(cols)
            for b in range(3):
                assert cfg.pod_k_for_bucket(b, cols) == \
                    rcfg.pod_k_for_bucket(b, cols)
                for n_data in (1, 2, 4, 16):
                    assert cfg.pod_k_max_for_bucket(b, cols, n_data) == \
                        rcfg.pod_k_max_for_bucket(b, cols, n_data)
        if ratios is not None:
            with pytest.raises(ValueError, match="index-aligned"):
                cfg.pod_k_for_bucket(3, 128)
            with pytest.raises(ValueError, match="index-aligned"):
                rcfg.pod_k_for_bucket(3, 128)


@pytest.mark.parametrize("change,match", [
    (dict(pod_dynamic=True, pod_axis=None), "pod_dynamic"),
    (dict(pod_dynamic=True, strategy="sparse_allgather"), "pod_dynamic"),
    (dict(pod_dynamic=True, bucketed=False), "pod_dynamic"),
    (dict(repack=True), "repack"),
    (dict(byte_budget=1000, strategy="sparse_allgather"), "byte_budget"),
    (dict(byte_budget=1000, bucketed=False), "byte_budget"),
])
def test_validate_raises_as_the_reference(change, match):
    cfg = dataclasses.replace(_hier(), **change)
    with pytest.raises(ValueError, match=match):
        cfg.validate()
    with pytest.raises(ValueError):
        _ref(cfg).validate()


def test_validate_pod_ratios_against_the_plan():
    plan, rplan = _plans()
    short = _hier(pod_ratios=(1.0,))
    for fn, p, c in ((validate_pod_ratios, plan, short),
                     (ref_validate_ratios, rplan, _ref(short))):
        with pytest.raises(ValueError, match="pod_ratios"):
            fn(c, p)
    with pytest.raises(ValueError, match="pod_ratios"):
        short.validate(plan)
    ok = _hier(pod_ratios=(1.0,) * len(plan.buckets))
    ok.validate(plan)
    _ref(ok).validate(rplan)
    # the legal combinations pass in both packages, pod_budgeted included
    for cfg in (_hier(pod_dynamic=True, repack=True, byte_budget=10 ** 5),
                SyncConfig.preset("pod_budgeted", pod_axis="pod")):
        cfg.validate(plan)
        _ref(cfg).validate(rplan)


# -- mask_live_k ----------------------------------------------------------


@pytest.mark.parametrize("k_max,k_live", [(16, 5), (16, 1), (8, 8),
                                          (8, 12)])
def test_mask_live_k_prefix_and_pads(k_max, k_live):
    x = torch.from_numpy(np.random.default_rng(k_live).standard_normal(
        (6, 96)).astype(np.float32))
    v_max, i_max = row_topk_ref(x, k_max)
    vm, im = mask_live_k(v_max, i_max, k_live)
    n = min(k_live, k_max)
    v_small, i_small = row_topk_ref(x, n)
    assert torch.equal(vm[:, :n], v_small) and torch.equal(im[:, :n],
                                                           i_small)
    # the pads are (-0.0, 0): the bits of negative zero
    assert torch.all(vm[:, n:].view(torch.int32) == -2 ** 31)
    assert torch.all(im[:, n:] == 0)
    rv, ri = ref_mask_live_k(jnp.asarray(v_max.numpy()),
                             jnp.asarray(i_max.numpy()), jnp.int32(k_live))
    np.testing.assert_array_equal(vm.view(torch.int32).numpy(),
                                  np.asarray(rv).view(np.int32))
    np.testing.assert_array_equal(im.numpy(), np.asarray(ri))


# -- the capture helpers --------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_capture_helpers_match_reference(seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((3, 24, 256)).astype(np.float32)
    u[:, 0] = 0.0  # an all-zero row counts as fully captured
    u[1, 3, :200] = 0.0
    for k_row in (1, 5, 12):
        pm = bk.simulate_pod_mean(torch.from_numpy(u), k_row)
        rpm = np.asarray(rbk.simulate_pod_mean(jnp.asarray(u), k_row))
        np.testing.assert_allclose(pm.numpy(), rpm, rtol=0, atol=1e-6)
        for max_k in (1, 7, 36, 256, 400):
            np.testing.assert_allclose(
                bk.bucket_mass_capture(pm, max_k).numpy(),
                np.asarray(rbk.bucket_mass_capture(jnp.asarray(rpm), max_k)),
                rtol=0, atol=1e-6)
        for support in (1, 3 * k_row, 256):
            np.testing.assert_allclose(
                bk.support_relative_capture(pm, support),
                rbk.support_relative_capture(jnp.asarray(rpm), support),
                rtol=0, atol=1e-6)


# -- the autotune and the budget controller -------------------------------


@pytest.mark.parametrize("shards", [None, N_DATA])
@pytest.mark.parametrize("capped", [False, True])
def test_autotune_and_budget_give_the_reference_ks(shards, capped):
    plan, rplan = _plans()
    cfg = _hier(k_min=2)
    rcfg = _ref(cfg)
    bufs = _bufs(plan, seed=3 + (shards or 0), shards=shards, heavy=(0,))
    caps = None
    if capped:
        caps = tuple(cfg.pod_k_max_for_bucket(b, s.cols, N_DATA) // 2 + 1
                     for b, s in enumerate(plan.buckets))
    tb = [torch.from_numpy(x) for x in bufs]
    jb = [jnp.asarray(x) for x in bufs]
    for target in (0.5, 0.9, 0.999):
        got = autotune_pod_ratios(cfg, plan, tb, N_DATA, mass_target=target,
                                  k_caps=caps)
        assert got == ref_autotune(rcfg, rplan, jb, N_DATA,
                                   mass_target=target, k_caps=caps)
    ctl = BudgetController(cfg, plan, N_DATA, k_caps=caps)
    rctl = RefBudgetController(rcfg, rplan, N_DATA, k_caps=caps)
    curves, rcurves = ctl.measure(tb), rctl.measure(jb)
    for c, rc in zip(curves, rcurves):
        assert (c.kind, c.support, c.k_cap, c.min_nbytes) == (
            rc.kind, rc.support, rc.k_cap, rc.min_nbytes)
        np.testing.assert_allclose(c.abs_capture, rc.abs_capture,
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(c.rel_capture, rc.rel_capture,
                                   rtol=0, atol=1e-6)
    floor = ctl.cross_bytes_of([1] * len(curves))
    span = ctl.cross_bytes_of([c.k_cap for c in curves]) - floor
    for budget in (0, floor, floor + span // 7, floor + span // 2,
                   floor + span, 10 ** 9):
        ks = ctl.allocate_bytes(curves, budget)
        assert ks == rctl.allocate_bytes(rcurves, budget), budget
        assert ctl.cross_bytes_of(ks) == rctl.cross_bytes_of(ks)
        assert ctl.ratios_of(ks) == rctl.ratios_of(ks)
        if budget >= floor:
            assert ctl.cross_bytes_of(ks) <= budget
    budgeted = dataclasses.replace(cfg, byte_budget=floor + span // 3)
    assert BudgetController(budgeted, plan, N_DATA).allocate(tb) == \
        RefBudgetController(_ref(budgeted), rplan, N_DATA).allocate(jb)


# -- the repack codec -----------------------------------------------------


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("live", [0, 1, 5, 11, 16])
def test_repack_round_trip_is_bitwise_and_matches_reference(value_dtype,
                                                            live):
    rows, cols, k_max = 9, 300, 16
    x = torch.from_numpy(np.random.default_rng(live).standard_normal(
        (rows, cols)).astype(np.float32))
    vals, idx = mask_live_k(*row_topk_ref(x, k_max), live)
    spec = enc.WireSpec(rows, cols, k_max, value_dtype)
    buf = enc.encode(spec, vals, idx, live_n=live)
    small_spec, small = enc.repack(spec, buf)
    assert small_spec.k == (max(1, live) if live else k_max)
    # the realized bytes are the accounted ones at the live k
    want = enc.message_nbytes(rows, cols, max(1, live) if live else k_max,
                              value_dtype, "packed")
    assert small.numel() * 4 == small_spec.nbytes == want
    assert torch.equal(enc.repad(spec, small_spec, small).view(torch.int32),
                       buf.view(torch.int32))
    padded, nbytes = repack_transport(spec, buf)
    assert nbytes == want and torch.equal(padded.view(torch.int32),
                                          buf.view(torch.int32))
    # the reference's compaction of the same buffer, bit for bit
    rspec = renc.WireSpec(rows, cols, k_max, value_dtype)
    rsmall_spec, rsmall = renc.repack(rspec, jnp.asarray(
        buf.view(torch.int32).numpy()).view(jnp.uint32))
    assert rsmall_spec.k == small_spec.k
    np.testing.assert_array_equal(small.view(torch.int32).numpy(),
                                  np.asarray(rsmall).view(np.int32))
    # the link= form: the compacted message over an emulated link, repadded
    # on .result(), bitwise the padded buffer; its bytes the reference's
    fut, nb_link = repack_transport(spec, buf, link=EmulatedLink())
    rfut, rnb = ref_transport(rspec, jnp.asarray(
        buf.view(torch.int32).numpy()).view(jnp.uint32), link=RefLink())
    assert nb_link == rnb == want
    assert torch.equal(fut.result().view(torch.int32), buf.view(torch.int32))
    np.testing.assert_array_equal(np.asarray(rfut.result()).view(np.int32),
                                  buf.view(torch.int32).numpy())


# -- the byte accounting by level -----------------------------------------


@pytest.mark.parametrize("wire", ["unpacked", "packed"])
def test_bucket_bytes_by_level_match_reference(wire):
    plan, rplan = _plans()
    live = tuple(3 if s.kind == "sparse" else 1 for s in plan.buckets)
    cases = [
        (_hier(wire=wire), {}),  # static
        (_hier(wire=wire, pod_ratios=(0.02, 0.05, 1.0)), {}),
        (_hier(wire=wire, pod_dynamic=True), dict(n_data=N_DATA)),  # padded
        (_hier(wire=wire, pod_dynamic=True, repack=True),
         dict(pod_ks=live)),  # effective
        (_hier(wire=wire, strategy="sparse_allgather"),
         dict(n_data=N_DATA)),  # flat: n_data messages cross
        (_hier(wire=wire, strategy="dense"), {}),
        (dataclasses.replace(_hier(wire=wire), pod_axis=None), {}),
    ]
    for cfg, kw in cases:
        got = bucketed_message_bytes(cfg, plan, by_level=True, **kw)
        assert got == ref_bucket_bytes(_ref(cfg), rplan, by_level=True,
                                       **kw), cfg
        assert got["total"] == bucketed_message_bytes(cfg, plan, **kw)
    flat = bucketed_message_bytes(cases[4][0], plan, by_level=True,
                                  n_data=N_DATA)
    two = bucketed_message_bytes(cases[3][0], plan, by_level=True,
                                 pod_ks=live)
    assert two["cross"] < flat["cross"]
    with pytest.raises(ValueError, match="n_data"):
        bucketed_message_bytes(cases[4][0], plan, by_level=True)
    with pytest.raises(ValueError, match="n_data"):
        bucketed_message_bytes(cases[2][0], plan)


@pytest.mark.parametrize("wire", ["unpacked", "packed"])
def test_leaf_bytes_with_the_pod_level_match_reference(wire):
    shapes = {"a": (64, 512), "b": (3, 40, 300), "c": (100,)}
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    rparams = {k: jnp.zeros(s) for k, s in shapes.items()}
    col_axes = {"a": None, "b": 1, "c": None}
    for cfg in (SyncConfig(strategy="hierarchical", ratio=0.02, wire=wire,
                           pod_axis="pod", pod_ratio=0.05),
                SyncConfig(strategy="hierarchical", ratio=0.02, wire=wire),
                SyncConfig(ratio=0.02, wire=wire, pod_axis="pod")):
        assert message_bytes(cfg, params, col_axes) == ref_message_bytes(
            _ref(cfg), rparams, col_axes)


def test_bf16_two_level_raises_by_name():
    """The two-level chain validates at bf16 wire values (its pod
    re-select runs the bf16 top-k kernels), with a pod axis or without
    (the flat chain), as the reference's does; a value dtype the port's
    wire does not take raises by name."""
    cfg = _hier(value_dtype="bfloat16")
    for c in (cfg, dataclasses.replace(cfg, pod_axis=None)):
        assert c.validate() is c
        _ref(c).validate()
    with pytest.raises(ValueError, match="float16"):
        dataclasses.replace(cfg, value_dtype="float16").validate()


def test_meshes_and_refresh_config_are_the_reference_s():
    assert {k: dataclasses.astuple(v) for k, v in MESHES.items()} == {
        k: dataclasses.astuple(v) for k, v in REF_MESHES.items()}
    assert dataclasses.asdict(PodRefreshConfig()) == dataclasses.asdict(
        RefPodRefreshConfig())
    assert PodRefreshConfig(every=2).enabled and not PodRefreshConfig().enabled
