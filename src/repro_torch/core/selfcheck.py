"""Self-checks of the bucket pipeline's invariants on a (pod, data)
layout (port of the part of ``repro.core.selfcheck`` that holds them).

Each check runs on every rank of a ``launch.mesh.Layout`` (the reference's
runs over a ``shard_map`` mesh), on the reference's tiny 2-bucket tree: a
(16, 384) leaf and a (40,) leaf at cols 128 and ``dense_below`` 64, so
one sparse and one dense bucket. Its inputs are made with numpy from
seeds; worker i's gradient is the tree's leaves times (1 + 0.1 i) plus
0.01 i, its memory seeded noise at 0.1 on the sparse bucket and zero on
the dense one. Every flag is the layout's: each rank's verdict, reduced
over every rank (the minimum). The result dicts keep the reference's
keys.

* ``overlap_selfcheck``: ``SyncConfig.overlap`` in {None, False, True}
  gives bitwise equal applied params and memory on the flat
  ``sparse_allgather`` path, the static two-level ``hierarchical`` path
  and the runtime-k ``pod_dynamic`` path across a live-k switch (9 -> 4).
* ``repack_selfcheck``: on the runtime-k path, ``repack`` on and off x
  every overlap gives bitwise equal params and memory across the switch;
  ``distributed.repack_transport`` (inline, and over an
  ``pipeline.EmulatedLink``) returns the k_max-padded buffer bit for bit;
  the bytes it ships equal ``encoding.message_nbytes`` at the live k and
  the sparse cross-pod term of ``bucketed_message_bytes(pod_ks=)``.

* ``local_quant_selfcheck``: the Qsparse-local-SGD invariants: the
  local-step accumulator at H = 1 bitwise the direct sync on the flat,
  two-level and runtime-k paths; under the quantized wire mass
  conservation, packed == unpacked bit for bit and the realized bytes
  equal to the accounting; ``amortized_bytes_per_step`` exactly 1/H.

The reference's ``two_level_selfcheck`` and ``dynamic_k_selfcheck`` hold
paths the port's tests hold already.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import buckets as bk
from repro_torch.core import encoding as enc
from repro_torch.core import pipeline
from repro_torch.core.distributed import (
    PodConfig,
    SyncConfig,
    WireConfig,
    _all_gather,
    amortized_bytes_per_step,
    bucketed_message_bytes,
    bucketed_sync_gradients,
    distributed,
    repack_transport,
)
from repro_torch.kernels import row_topk
from repro_torch.kernels.topk_select import mask_live_k

COLS, DENSE_BELOW = 128, 64
OVERLAPS = (None, False, True)


def bitwise_equal(a, b) -> bool:
    """True iff the two trees have the same number of leaves and every
    leaf pair has the same shape, dtype and BYTES (a float ``==`` would
    miss -0.0 against +0.0 and NaN payloads). A truncating ``zip`` over
    leaf lists of different lengths would pass silently; this does not."""
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return False
    return all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(_bytes(x), _bytes(y).to(x.device))
        for x, y in zip(la, lb))


def _leaves(tree) -> list:
    """A tree's tensors: dicts by sorted key, lists and tuples by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _every_rank(flag: bool, device) -> bool:
    """``flag`` on every rank of the default group (the minimum)."""
    if not distributed():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MIN)
    return bool(t.item())


def _probe(layout, device):
    """The tiny tree, its plan, this rank's gradient tree and memory
    buffers (float32 on ``device``)."""
    tree_np = {"w": np.random.default_rng(0).standard_normal(
        (16, 384)).astype(np.float32),
        "b": np.random.default_rng(1).standard_normal(40).astype(np.float32)}
    tree = {k: torch.from_numpy(v).to(device) for k, v in tree_np.items()}
    plan = bk.make_plan(tree, cols=COLS, dense_below=DENSE_BELOW)
    i = layout.rank
    grads = {k: torch.from_numpy(v * np.float32(1 + 0.1 * i)
                                 + np.float32(0.01 * i)).to(device)
             for k, v in tree_np.items()}
    mem = [torch.from_numpy(
        (np.random.default_rng(9 + b).standard_normal(
            (layout.world,) + s.shape)[i]
         * (0.1 if s.kind == "sparse" else 0.0)).astype(np.float32)
    ).to(device) for b, s in enumerate(plan.buckets)]
    return tree, plan, grads, mem


def _pod_ks(plan, k: int) -> tuple:
    return tuple(k if s.kind == "sparse" else 1 for s in plan.buckets)


def _ratios(plan, r: float) -> tuple:
    return tuple(r if s.kind == "sparse" else 1.0 for s in plan.buckets)


def _chained(cfg, layout, tree, plan, grads, mem, eta, schedule):
    """Steps of the sync from ``mem``, one per entry of ``schedule`` (the
    live pod ks, or None): (the applied params of each step, the last
    memory)."""
    mem = [m.clone() for m in mem]
    applied = []
    for ks in schedule:
        upd, mem, _ = bucketed_sync_gradients(cfg, plan, mem, grads, eta,
                                              layout=layout, pod_ks=ks)
        mem = list(mem)
        applied.append([tree[k] - upd[k] for k in sorted(tree)])
    return applied, mem


def _paths(plan, ratio: float, wire: str, quant=None) -> dict:
    """The three bucketed sync paths on the tiny plan: flat over every
    worker, static two-level (the sparse bucket's pod ratio 0.1), runtime
    k (pod ratio 9 / COLS, the k_max-padded chain)."""
    base = dict(ratio=ratio, bucketed=True, bucket_cols=COLS,
                wire=WireConfig(wire=wire, quant=quant))
    return {
        "flat": SyncConfig(strategy="sparse_allgather",
                           pod=PodConfig(axis="pod"), **base),
        "hierarchical": SyncConfig(
            strategy="hierarchical",
            pod=PodConfig(axis="pod", ratios=_ratios(plan, 0.1)), **base),
        "pod_dynamic": SyncConfig(
            strategy="hierarchical",
            pod=PodConfig(axis="pod", ratios=_ratios(plan, 9 / COLS),
                          dynamic=True), **base),
    }


def overlap_selfcheck(layout, ratio: float = 0.05, eta: float = 0.3,
                      wire: str = "packed", device="cpu") -> dict:
    """The pipelined schedule's bit identity on ``layout``: for each sync
    path (flat, static two-level, runtime-k with a live-k refresh 9 -> 4
    between two chained steps), overlap None, False and True give
    bitwise equal applied params and memory on every rank."""
    tree, plan, grads, mem0 = _probe(layout, device)
    paths = {name: (cfg, [_pod_ks(plan, 9), _pod_ks(plan, 4)]
                    if name == "pod_dynamic" else [None])
             for name, cfg in _paths(plan, ratio, wire).items()}
    out = {}
    for name, (cfg, schedule) in paths.items():
        runs = [_chained(cfg.with_transport(overlap=ov), layout, tree,
                         plan, grads, mem0, eta, schedule)
                for ov in OVERLAPS]
        out[f"{name}_bitwise"] = _every_rank(
            all(bitwise_equal(runs[0], r) for r in runs[1:]), device)
    out["bitwise_all"] = all(out.values())
    return out


def repack_selfcheck(layout, ratio: float = 0.05, eta: float = 0.3,
                     ks=(9, 4), device="cpu") -> dict:
    """The header-aware repack transport's invariants on ``layout``:

    * **repack_bitwise**: on the runtime-k path, ``repack`` on and off x
      overlap in {None, False, True}, chained across a live-k switch
      (``ks[0] -> ks[1]``), give bitwise equal applied params and memory
      (the R stage is the identity inside the step and only grows the
      schedule);
    * **transport_roundtrip_bitwise**: ``repack_transport`` inline and
      over an ``EmulatedLink`` future returns the k_max-padded buffer bit
      for bit;
    * **transport_accounting_exact**: the bytes it ships equal
      ``encoding.message_nbytes(..., live_k)`` and the sparse cross-pod
      term of ``bucketed_message_bytes(..., pod_ks=)``;
    * **padded_vs_live_bytes**: the (padded, live) cross-pod bytes of the
      sparse bucket, the gap the transport closes."""
    tree, plan, grads, mem0 = _probe(layout, device)
    dyn = _paths(plan, ratio, "packed")["pod_dynamic"].with_pod(
        ratios=_ratios(plan, ks[0] / COLS))
    schedule = [_pod_ks(plan, k) for k in ks]
    runs = [_chained(dyn.with_transport(repack=rp, overlap=ov), layout,
                     tree, plan, grads, mem0, eta, schedule)
            for rp in (False, True) for ov in OVERLAPS]
    repack_bitwise = _every_rank(
        all(bitwise_equal(runs[0], r) for r in runs[1:]), device)

    # the host transport on a k_max-padded pod summary of the sparse
    # bucket, its tail masked to (-0.0, 0) past the live k
    b = next(i for i, s in enumerate(plan.buckets) if s.kind == "sparse")
    spec = plan.buckets[b]
    k_max = dyn.pod_k_max_for_bucket(b, spec.cols, layout.n_data)
    k_live = int(ks[-1])
    u = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (spec.rows, spec.cols)).astype(np.float32)).to(device)
    vals, idx = mask_live_k(*row_topk(u, k_max), k_live)
    wspec = enc.WireSpec(spec.rows, spec.cols, k_max)
    buf = enc.encode(wspec, vals, idx, live_n=k_live)
    out_inline, nb_inline = repack_transport(wspec, buf)
    fut, nb_link = repack_transport(wspec, buf,
                                    link=pipeline.EmulatedLink())
    roundtrip = _every_rank(bitwise_equal(out_inline, buf)
                            and bitwise_equal(fut.result(), buf), device)
    live_bytes = enc.message_nbytes(spec.rows, spec.cols, k_live, "float32",
                                    "packed")
    lv = bucketed_message_bytes(dyn, plan, by_level=True,
                                n_data=layout.n_data,
                                pod_ks=_pod_ks(plan, k_live))
    dense_cross = sum(s.rows * s.cols * 4 for s in plan.buckets
                      if s.kind == "dense")
    acc_ok = (nb_inline == live_bytes and nb_link == live_bytes
              and lv["cross"] - dense_cross == live_bytes)
    return {
        "repack_bitwise": repack_bitwise,
        "transport_roundtrip_bitwise": roundtrip,
        "transport_accounting_exact": bool(acc_ok),
        "padded_vs_live_bytes": [wspec.nbytes, live_bytes],
    }


def local_quant_selfcheck(layout, ratio: float = 0.05, eta: float = 0.3,
                          quant: int = 15, hs=(2, 4, 8),
                          device="cpu") -> dict:
    """The Qsparse-local-SGD invariants on ``layout``, on the tiny tree:

    * **h1_accum_bitwise**: the local-step accumulator path
      (``buckets.init_local_accum`` + ``accumulate_local`` at eta, then the
      sync of the accumulator through ``grad_bufs=`` at eta 1.0) gives the
      direct sync's update and memory bit for bit at H = 1, on the flat,
      the two-level and the runtime-k (``pod_dynamic``) paths: ``1.0 *
      (0 + eta*g)`` is ``eta*g``;
    * **quant_conservation_max_err**: under ``WireConfig.quant``, the
      largest |mean_w(u) - (update + mean_w(m'))| over both buckets, flat
      and two-level (float-sum association is the only slack: the memory
      keeps the quantization error);
    * **quant_bit_identical**: packed and unpacked wires give the same
      update and memory bit for bit (both densify
      ``encoding.dequantize_rows`` of the same codes);
    * **quant_accounting_exact**: the realized bytes equal
      ``bucketed_message_bytes`` of the quantized config;
    * **amortized_ratio_exact**: ``amortized_bytes_per_step`` is exactly
      the sync's bytes / H for every H in ``hs``.

    The rounding noise is ``QuantNoise(5, 0)`` (the reference's check
    keys it with PRNGKey(5))."""
    from repro_torch.optim.qsgd import QuantNoise

    noise = QuantNoise(5, 0)
    tree, plan, grads, mem0 = _probe(layout, device)
    realized = {}

    def run(cfg, accumulate=False, pod_ks=None, tag=None):
        kw = dict(layout=layout, pod_ks=pod_ks)
        if cfg.quant is not None:
            kw["quant_noise"] = noise
        mem = [m.clone() for m in mem0]
        if accumulate:
            acc = bk.accumulate_local(plan, bk.init_local_accum(
                plan, device=device), grads, eta)
            upd, mem, nbytes = bucketed_sync_gradients(
                cfg, plan, mem, None, 1.0, grad_bufs=acc, **kw)
        else:
            upd, mem, nbytes = bucketed_sync_gradients(cfg, plan, mem, grads,
                                                       eta, **kw)
        if tag is not None:
            realized[tag] = nbytes
        return [upd[k] for k in sorted(upd)], list(mem)

    h1_ok = True
    for name, cfg in _paths(plan, ratio, "packed").items():
        pk = _pod_ks(plan, 9) if name == "pod_dynamic" else None
        h1_ok = h1_ok and bitwise_equal(run(cfg, pod_ks=pk),
                                        run(cfg, accumulate=True, pod_ks=pk))

    cons_err, bit_ok, acc_ok = 0.0, True, True
    g_bufs = bk.pack(plan, grads, dtype=torch.float32)
    u = [torch.add(m, torch.mul(g, float(np.float32(eta))))
         for m, g in zip(mem0, g_bufs)]
    for name in ("flat", "hierarchical"):
        cfgs = {w: _paths(plan, ratio, w, quant)[name]
                for w in ("packed", "unpacked")}
        out_p = run(cfgs["packed"], tag=name)
        bit_ok = bit_ok and bitwise_equal(out_p, run(cfgs["unpacked"]))
        acc_ok = acc_ok and realized[name] == bucketed_message_bytes(
            cfgs["packed"], plan)
        upd_bufs = bk.pack(plan, dict(zip(sorted(tree), out_p[0])),
                           dtype=torch.float32)
        for b in range(len(plan.buckets)):
            lhs = _all_gather(u[b]).mean(0)
            rhs = upd_bufs[b] + _all_gather(out_p[1][b]).mean(0)
            cons_err = max(cons_err, float(torch.max(torch.abs(lhs - rhs))))

    q = _paths(plan, ratio, "packed", quant)["flat"]
    full = bucketed_message_bytes(q, plan)
    ratio_ok = all(amortized_bytes_per_step(
        dataclasses.replace(q, local_steps=h), plan) == full / h for h in hs)
    return {
        "h1_accum_bitwise": _every_rank(h1_ok, device),
        "quant_conservation_max_err": cons_err,
        "quant_bit_identical": _every_rank(bit_ok, device),
        "quant_accounting_exact": _every_rank(acc_ok, device),
        "amortized_ratio_exact": _every_rank(ratio_ok, device),
    }
