"""PARALLEL-MEM-SGD gradient sync (port of ``repro.core.distributed``):
the bucketed path and the per-leaf path, flat or two-level.

Each data-parallel worker w:

  1. holds its own error-feedback memory m_w (paper Algorithm 2),
  2. forms u_w = m_w + eta * g_w for its local gradient g_w,
  3. selects ROW-BLOCK top-k (values, indices) per bucket or leaf row,
  4. exchanges only those pairs (all-gather over the workers),
  5. scatters the W*k received pairs into a dense update and divides by W,
  6. keeps m_w' = u_w - own_selection.

A sparse bucket or leaf runs the reference's stage order (its
``_sparse_stages``): select -> encode -> gather -> decode -> densify -> / W.
``bucketed_sync_gradients`` runs steps 2, 3 and 6 as one fused CUDA
kernel per sparse bucket (``kernels.fused_memsgd_update``, its branch
resolved from k by ``method="auto"``, from the fused kernel's own measured
cutover on the card): its residual m' is
the reference's ``u - own`` (up to the sign of zero at selected entries).
``sparse_sync_gradients``, the per-leaf path (the train CLI's default),
forms u per leaf, moves the leaf's column axis last and selects with
``kernels.row_topk``: the reference's ``selection`` variants exist for
XLA's partitioner, and in the port each maps to a top-k method of one
contract (``_row_topk_method``).

The two-level sync (``strategy="hierarchical"`` with a ``pod_axis``, on a
``launch.mesh.Layout`` of (pod, data) process groups; the reference's
``_hier_stages``): the workers' pairs gather inside their pod at k_row,
each worker densifies the pod mean, re-selects it at the bucket's pod k
(``kernels.row_topk``) and keeps the pod residual (the pod mean less what
it selected) in its memory; only that summary gathers across the pods,
and the update is its densified mean over the pods. With
``pod_dynamic`` the pod k is a live host int per bucket (``pod_ks``):
every shape, wire buffer and gather stays at the static ceiling
``pod_k_max_for_bucket`` and ``kernels.topk_select.mask_live_k`` pads the
tail with (-0.0, 0) no-ops, whose count the packed header carries. The
``repack`` boundary before the cross-pod gather is the identity inside a
step, as the reference's in-trace one; ``repack_transport`` is the
transport's half (inline; ``bucketed_message_bytes(pod_ks=)`` accounts
it). A hierarchical sync without a pod axis is the flat chain.

The wire: ``"unpacked"`` gathers the (value_dtype values, int32 indices)
arrays; ``"packed"`` encodes each worker's pairs into one uint32 buffer
(``core.encoding``), gathers the buffers (their int32 view) and decodes
them. Gathered pairs tile along the last axis in rank order, and the
densify adds them one worker at a time in that order (within a worker a
row's indices are distinct), so packed and unpacked give the same bits and
every rank the same update. Dense leaves and buckets take a mean
all-reduce over every worker (the reference's ``pmean``).

Workers: the ``torch.distributed`` group whenever one is initialised (NCCL
on the card, gloo on the CPU; W = 1 included, so the card runs the NCCL
gather), else one worker whose gather is the identity; the two-level
chain gathers over the layout's data and pod groups.

The densify takes the reference's form for the selection
(``_densify_onehot``, its ``_pick_selection``): the one-hot form sums a
column's pairs in float32 and rounds once to the wire's value dtype, the
scatter form adds each pair in that dtype; at float32, and at bf16 with
two terms a column, the two give the same bits. Where the reference's
pod re-select is its argmax loop, its compiled keys are the pod mean's
float32 product before the rounding to bf16 (``_pod_mean_select``).

What the port runs: the ``sparse_allgather``, ``hierarchical`` and
``dense`` strategies, both wires, float32 or bf16 wire values (flat and
two-level: the bf16 pod mean is re-selected by the bf16 row top-k
kernels, or on its float32 keys where the reference's argmax loop keeps
them), any number of workers, and the ``dense``, ``topk`` and
``pod_budgeted`` presets. Every other option raises
``NotImplementedError`` naming it: quantization, local steps > 1 and the
overlap schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import buckets as bk
from repro_torch.core import encoding as enc
from repro_torch.kernels import fused_memsgd_update, row_topk
from repro_torch.kernels.ref import eta32
from repro_torch.kernels.topk_select import mask_live_k
from repro_torch.utils.platform import TOPK_LOOP_CUTOVER
from repro_torch.utils.tree import tree_flatten

STRATEGIES = ("sparse_allgather", "hierarchical", "dense")
SELECTIONS = ("topk_scatter", "argmax_onehot", "threshold_onehot")
VALUE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """How gradients are synchronized across the data-parallel workers.

    Flat fields with the reference's names and defaults (the reference
    groups the pod/wire/transport knobs into sub-configs and reads them
    back under these flat names). The reference's ``layout`` and
    ``constrain_intermediates`` serve its partitioner and have no
    counterpart: with no model axis (each worker holds whole tensors)
    every layout selects over the same rows."""

    strategy: str = "sparse_allgather"  # | "hierarchical" | "dense"
    ratio: float = 0.001  # per-row k_row = max(k_min, ratio * row_len)
    k_min: int = 1
    k_max: Optional[int] = None
    local_steps: int = 1  # > 1 (Qsparse-local-SGD) not ported
    dense_below: int = 16_384  # smaller leaves sync densely
    # the reference's selection implementations; every one gives the same
    # contract. The bucketed path runs each on the fused kernel; the
    # per-leaf path and the pod re-select map each to a top-k method
    # (_row_topk_method)
    selection: str = "argmax_onehot"
    argmax_k_limit: int = 64  # argmax_onehot takes the threshold above it
    bucketed: bool = False  # False: the per-leaf path
    bucket_cols: int = 1024
    wire: str = "unpacked"  # | "packed" (core.encoding)
    value_dtype: str = "float32"
    quant: Optional[int] = None  # QSGD levels, not ported
    overlap: Optional[bool] = None  # bucket pipeline schedule, not ported
    # the two-level (hierarchical) sync: the pod re-compression ratio
    # (None: ``ratio``), per-bucket ratios index-aligned with the bucket
    # plan (``autotune_pod_ratios``), the autotune's mass-capture target,
    # the runtime pod k (bucketed only), a cap on its static padded k as
    # a fraction of cols, and the pod axis (the launcher sets "pod" on a
    # layout of more than one pod)
    pod_ratio: Optional[float] = None
    pod_ratios: Optional[Tuple[float, ...]] = None
    pod_mass_target: float = 0.9
    pod_dynamic: bool = False
    pod_k_max_ratio: Optional[float] = None
    pod_axis: Optional[str] = None
    # the header-aware repack boundary before the cross-pod gather (the
    # identity inside a step), and the cross-pod byte budget per step per
    # worker that ``core.budget.BudgetController`` water-fills
    repack: bool = False
    byte_budget: Optional[int] = None

    def __post_init__(self):
        if self.pod_ratios is not None and not isinstance(self.pod_ratios,
                                                          tuple):
            object.__setattr__(self, "pod_ratios", tuple(self.pod_ratios))

    @classmethod
    def preset(cls, name: str, **overrides) -> "SyncConfig":
        """A known-good bundle of the reference's (``SyncConfig.preset``),
        with flat ``overrides`` set on top:

        * ``"dense"``        — vanilla data-parallel all-reduce.
        * ``"topk"``         — the paper's Mem-SGD: bucketed top-k over the
          packed wire.
        * ``"pod_budgeted"`` — the two-level pod sync with runtime pod k
          and the repack boundary (give it ``byte_budget=`` to water-fill;
          the launcher sets ``pod_axis`` from the layout).
        * ``"qsparse_local"`` is not ported (local steps with
          quantization) and raises ``NotImplementedError``.
        """
        if name in _UNPORTED_PRESETS:
            raise NotImplementedError(
                f"SyncConfig preset {name!r} ({_UNPORTED_PRESETS[name]}) is "
                "not ported to the PyTorch port yet")
        if name not in _PRESETS:
            raise ValueError(
                f"unknown SyncConfig preset {name!r}; available: "
                f"{sorted(list(_PRESETS) + list(_UNPORTED_PRESETS))}")
        return dataclasses.replace(cls(**_PRESETS[name]), **overrides)

    def validate(self, plan=None) -> "SyncConfig":
        """Raise a named error for an unknown value or an illegal
        combination (``ValueError``, the reference's) or an option the
        port does not run yet (``NotImplementedError``). With the bucket
        ``plan``, also check that ``pod_ratios`` is aligned with it."""
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown sync strategy {self.strategy!r}")
        if self.selection not in SELECTIONS:
            raise ValueError(
                f"unknown SyncConfig.selection {self.selection!r}")
        if self.wire not in ("unpacked", "packed"):
            raise ValueError(f"unknown wire format {self.wire!r}")
        if self.value_dtype not in VALUE_DTYPES:
            raise ValueError(
                f"unsupported value_dtype {self.value_dtype!r}; options: "
                f"{VALUE_DTYPES}")
        if self.local_steps < 1:
            raise ValueError(
                f"SyncConfig.local_steps must be >= 1, got {self.local_steps}")
        if self.pod_dynamic and (self.strategy != "hierarchical"
                                 or self.pod_axis is None
                                 or not self.bucketed):
            raise ValueError(
                "SyncConfig.pod_dynamic (runtime pod k) requires the bucketed "
                "hierarchical strategy with a pod axis: this config would "
                "ignore the live k schedule")
        if self.repack and not self.pod_dynamic:
            raise ValueError(
                "SyncConfig.repack requires pod_dynamic: the repack boundary "
                "compacts the k_max-padded pod summary, which only exists "
                "on the runtime-k path")
        if self.byte_budget is not None and (self.strategy != "hierarchical"
                                             or not self.bucketed):
            raise ValueError(
                "SyncConfig.byte_budget requires the bucketed hierarchical "
                "strategy: the budget water-fills per-bucket pod ks across "
                "a BucketPlan")
        unported = [
            (self.quant is not None, "quant (QSGD wire quantization)"),
            (self.local_steps > 1, "local_steps > 1"),
            (self.overlap is not None, "overlap (bucket pipeline)"),
        ]
        for hit, name in unported:
            if hit:
                raise NotImplementedError(
                    f"SyncConfig {name} is not ported to the PyTorch port yet")
        if plan is not None:
            validate_pod_ratios(self, plan)
        return self

    def k_for(self, row_len: int) -> int:
        k = max(self.k_min, int(round(self.ratio * row_len)))
        if self.k_max is not None:
            k = min(k, self.k_max)
        return min(k, row_len)

    def pod_k_for(self, row_len: int) -> int:
        r = self.pod_ratio if self.pod_ratio is not None else self.ratio
        k = max(self.k_min, int(round(r * row_len)))
        if self.k_max is not None:
            k = min(k, self.k_max)
        return min(k, row_len)

    def pod_k_for_bucket(self, bucket: int, row_len: int) -> int:
        """Pod-stage k of one bucket: its ``pod_ratios`` entry when set
        (an out-of-range bucket raises: the ratios must be aligned with
        the plan), else ``pod_k_for``."""
        if self.pod_ratios is None:
            return self.pod_k_for(row_len)
        if bucket >= len(self.pod_ratios):
            raise ValueError(
                f"SyncConfig.pod_ratios has {len(self.pod_ratios)} entries "
                f"but bucket {bucket} was requested: pod_ratios must be "
                "index-aligned with the BucketPlan (one ratio per bucket; "
                "regenerate with autotune_pod_ratios)")
        k = max(self.k_min, int(round(self.pod_ratios[bucket] * row_len)))
        if self.k_max is not None:
            k = min(k, self.k_max)
        return min(k, row_len)

    def pod_k_max_for_bucket(self, bucket: int, row_len: int,
                             n_data: int) -> int:
        """Static ceiling of one bucket's pod k, the size the dynamic path
        shapes its buffers, wire and gathers at: the pod mean's support
        bound (``n_data * k_row``), tightened by ``pod_k_max_ratio``, and
        never below the configured pod k."""
        cap = min(row_len, max(1, n_data * self.k_for(row_len)))
        if self.pod_k_max_ratio is not None:
            cap = min(cap, max(self.k_min,
                               int(round(self.pod_k_max_ratio * row_len))))
        return min(row_len, max(cap, self.pod_k_for_bucket(bucket, row_len)))


def validate_pod_ratios(cfg: SyncConfig, plan) -> None:
    """Raise unless ``cfg.pod_ratios`` (when set) has one entry per bucket
    of ``plan``: a shorter tuple would desync the byte accounting from
    what the wire ships."""
    if cfg.pod_ratios is None:
        return
    if len(cfg.pod_ratios) != len(plan.buckets):
        raise ValueError(
            f"SyncConfig.pod_ratios has {len(cfg.pod_ratios)} entries for "
            f"a {len(plan.buckets)}-bucket plan: regenerate them with "
            "autotune_pod_ratios (one ratio per bucket, dense buckets "
            "included)")


# the reference's bundles (its _PRESETS), in the port's flat fields
_PRESETS = {
    "dense": dict(strategy="dense"),
    "topk": dict(strategy="sparse_allgather", bucketed=True, wire="packed"),
    "pod_budgeted": dict(strategy="hierarchical", bucketed=True,
                         wire="packed", pod_dynamic=True, repack=True),
}
_UNPORTED_PRESETS = {
    "qsparse_local": "local steps with quant, the QSGD wire",
}


def distributed() -> bool:
    """Whether a torch.distributed group is initialised: the sync then
    gathers through it, whatever its size."""
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def world_size() -> int:
    """Data-parallel workers: the torch.distributed world, else 1."""
    return torch.distributed.get_world_size() if distributed() else 1


def _all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n,) + x.shape: every member's x in the group's rank order (the
    world without a ``group``; x itself, with a leading axis, without
    torch.distributed)."""
    if not distributed():
        return x.unsqueeze(0)
    n = torch.distributed.get_world_size(group)
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    torch.distributed.all_gather_into_tensor(out, x.contiguous().view(-1),
                                             group=group)
    return out.view((n,) + tuple(x.shape))


def _mean(u: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of u over the group's members (every worker without a
    ``group``; the reference's ``pmean``): a sum all-reduce of a copy,
    then / n."""
    if not distributed():
        return u
    out = u.clone()
    torch.distributed.all_reduce(out, group=group)
    n = torch.distributed.get_world_size(group)
    return out.div_(n) if n > 1 else out


def _gather_pairs(vals: torch.Tensor, idx: torch.Tensor, group=None):
    """(rows, k) pairs -> every member's, tiled along the last axis in
    rank order: (rows, n*k)."""
    rows, k = vals.shape
    tile = lambda x: x.movedim(0, 1).reshape(rows, -1)  # noqa: E731
    return tile(_all_gather(vals, group)), tile(_all_gather(idx, group))


def _gather_buf(buf: torch.Tensor, group=None) -> torch.Tensor:
    """Every member's wire buffer, (n, words) uint32, in rank order (the
    collective moves their int32 view)."""
    return _all_gather(buf.view(torch.int32), group).view(torch.uint32)


def _decode_packed(bufs: torch.Tensor, wspec: enc.WireSpec):
    """(n, words) gathered buffers -> pairs (rows, n*k) in the tile order
    of ``_gather_pairs``, so the densify sees the unpacked wire's
    pairs."""
    vals, idx = zip(*(enc.decode(wspec, b) for b in bufs))
    tile = lambda xs: torch.stack(xs, 1).reshape(wspec.rows, -1)  # noqa
    return tile(vals), tile(idx)


def _exchange(cfg: "SyncConfig", vals: torch.Tensor, idx: torch.Tensor,
              cols: int, group=None):
    """The wire stages of one sparse bucket or leaf: this worker's (rows,
    k) pairs -> every group member's, (rows, n*k) values in
    ``value_dtype`` and int32 indices. Packed: encode -> gather ->
    decode; unpacked: gather."""
    value_dtype = getattr(torch, cfg.value_dtype)
    if cfg.wire == "packed":
        rows, k = vals.shape
        wspec = enc.WireSpec(rows, cols, k, cfg.value_dtype)
        return _decode_packed(_gather_buf(enc.encode(wspec, vals, idx),
                                          group), wspec)
    return _gather_pairs(vals.to(value_dtype), idx, group)


def _densify_onehot(cfg: "SyncConfig", k_row: int) -> bool:
    """Whether the reference densifies a leaf's or bucket's pairs by its
    one-hot einsum (``_row_densify_onehot``: a column's sum in float32,
    rounded once) rather than its scatter (``_row_scatter``: one add per
    pair in the value dtype): its ``_pick_selection`` at the level-1
    ``k_row``, which picks the two-level chain's every densify too."""
    return cfg.selection == "threshold_onehot" or (
        cfg.selection == "argmax_onehot" and k_row <= cfg.argmax_k_limit)


def _densify_sum(out: torch.Tensor, col_axis: int, gv: torch.Tensor,
                 gi: torch.Tensor, k: int, onehot: bool) -> int:
    """The gathered pairs (rows, n*k) summed along ``col_axis`` of the zero
    tensor ``out`` (the wire's value dtype), in place; returns n. One
    ``scatter_add_`` per worker, in rank order (a row's indices are
    distinct within one worker, and a live-k pad adds -0.0, so no two adds
    race). ``onehot`` sums in float32 and casts once (the reference's
    one-hot form), else each add rounds to ``out``'s dtype; with two terms
    a column the two forms give the same bits, so the float32 buffer is
    taken only for three workers or more."""
    view = out.movedim(col_axis, -1)
    acc = view
    lead = view.shape[:-1]
    n = gv.shape[1] // k
    if onehot and out.dtype != torch.float32 and n > 2:
        acc = torch.zeros(view.shape, dtype=torch.float32, device=out.device)
    for w in range(n):
        part = slice(w * k, (w + 1) * k)
        acc.scatter_add_(-1, gi[:, part].to(torch.int64).reshape(*lead, k),
                         gv[:, part].reshape(*lead, k).to(acc.dtype))
    if acc is not view:
        view.copy_(acc)
    return n


def _densify_mean(out: torch.Tensor, col_axis: int, gv: torch.Tensor,
                  gi: torch.Tensor, k: int, onehot: bool) -> torch.Tensor:
    """``_densify_sum``, then the mean over the n workers in ``out``'s
    dtype, in place (the pod mean): at float32 / n; at bf16 the float32
    sum times float32(1/n), rounded once to bf16, as the reference's
    compiled divide by a constant (a multiply by its float32 reciprocal;
    the same bits as / n for n a power of two)."""
    n = _densify_sum(out, col_axis, gv, gi, k, onehot)
    if n == 1:
        return out
    if out.dtype == torch.float32:
        return out.div_(n)
    return out.copy_(out.to(torch.float32).mul_(_reciprocal32(n)))


def _densify_update(out: torch.Tensor, col_axis: int, gv: torch.Tensor,
                    gi: torch.Tensor, k: int, onehot: bool) -> torch.Tensor:
    """``_densify_sum``, then the mean over the n workers as float32 (an
    update): at float32 ``out`` / n in place; at bf16 the bf16 sum widened,
    times float32(1/n), left unrounded. That is the reference's compiled
    ``(densify(...) / n).astype(float32)``: its divide is a float32
    multiply by the reciprocal, and the cast that follows drops the
    rounding to bf16 between them (XLA's excess precision)."""
    n = _densify_sum(out, col_axis, gv, gi, k, onehot)
    if out.dtype == torch.float32:
        return out.div_(n) if n > 1 else out
    up = out.to(torch.float32)
    return up.mul_(_reciprocal32(n)) if n > 1 else up


def _pod_mean_select(cfg: "SyncConfig", pod_mean: torch.Tensor,
                     gv: torch.Tensor, gi: torch.Tensor, k_row: int,
                     k_pod: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pod mean of the gathered pairs into the zero (rows, cols)
    ``pod_mean`` (the wire's value dtype, ``_densify_mean``) and its
    re-select at ``k_pod``: (pvals in that dtype, pidx).

    Where the reference's re-select is its argmax loop
    (``_row_topk_argmax``, by ``_pick_selection`` at the level-1
    ``k_row``), its compiled keys ``abs(u.astype(float32))`` drop the
    rounding of ``densify(...) / n`` to bf16: they are the bf16 sum times
    float32(1/n), unrounded, as in ``_densify_update``. At bf16 the port
    then selects on that float32 product and rounds the values it took,
    which are the pod mean's. Its other re-selects (the threshold
    select's bit keys, the kernel) see the bf16 pod mean."""
    onehot = _densify_onehot(cfg, k_row)
    method = _row_topk_method(cfg, k_pod)
    if pod_mean.dtype == torch.float32 or not _reselect_is_argmax(cfg, k_row):
        _densify_mean(pod_mean, 1, gv, gi, k_row, onehot)
        return row_topk(pod_mean, k_pod, method=method)
    keys = _densify_update(pod_mean, 1, gv, gi, k_row, onehot)
    pod_mean.copy_(keys)
    pvals, pidx = row_topk(keys, k_pod, method=method)
    return pvals.to(pod_mean.dtype), pidx


def _reselect_is_argmax(cfg: "SyncConfig", k_row: int) -> bool:
    """Whether the reference's ``_pick_selection`` at the level-1 ``k_row``
    gives its argmax loop: ``argmax_onehot`` up to ``argmax_k_limit``,
    ``threshold_onehot`` up to its loop cutover on the CPU, where the two
    packages are held against each other."""
    if cfg.selection == "threshold_onehot":
        return k_row <= TOPK_LOOP_CUTOVER["cpu"]
    return cfg.selection == "argmax_onehot" and k_row <= cfg.argmax_k_limit


def _reciprocal32(n: int) -> float:
    """1/n rounded to float32 (exact as a Python float)."""
    return float(np.float32(1.0 / n))


def _flat_update(cfg: "SyncConfig", like: torch.Tensor, col_axis: int,
                 vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The flat chain after the select: every worker's pairs, densified
    into a tensor of ``like``'s layout, / W, as float32."""
    gv, gi = _exchange(cfg, vals, idx, like.shape[col_axis])
    out = torch.zeros_like(like, dtype=getattr(torch, cfg.value_dtype))
    k_row = vals.shape[1]
    return _densify_update(out, col_axis, gv, gi, k_row,
                           _densify_onehot(cfg, k_row))


def _two_level_layout(cfg: "SyncConfig", layout):
    """The layout the two-level chain runs over, or None for the flat
    chain: the hierarchical strategy with a pod axis needs the (pod,
    data) groups; without a pod axis it is the flat chain, as the
    reference's."""
    if cfg.strategy != "hierarchical" or cfg.pod_axis is None:
        return None
    if layout is None:
        raise ValueError(
            "the two-level sync (strategy='hierarchical' with a pod_axis) "
            "needs layout=, a (pod, data) repro_torch.launch.mesh.Layout")
    return layout


def _two_level_update(cfg: "SyncConfig", layout, memory: torch.Tensor,
                      col_axis: int, vals: torch.Tensor, idx: torch.Tensor,
                      k_pod: int, k_live: Optional[int] = None,
                      level_bytes: Optional[dict] = None) -> torch.Tensor:
    """The two-level chain after this worker's level-1 select (the
    reference's ``_hier_stages``): gather the (rows, k_row) pairs in the
    pod, densify the pod mean (rows, cols), re-select it at ``k_pod``
    (``k_live`` live slots: ``mask_live_k``), add the pod residual, the
    pod mean with the live selection zeroed, into ``memory`` (u - own, in
    place, ``col_axis`` its column axis), gather the summary across the
    pods and return its densified mean over the pods, float32, in
    ``memory``'s layout.

    The pod mean, its re-select and the residual stay in ``value_dtype``
    until the final cast (at bf16 the re-select is the bf16 row top-k,
    or the float32 one on the reference's argmax keys:
    ``_pod_mean_select``; ``memory.add_`` widens the residual into the float32 memory, as the
    reference's ``(u - own) + residual``). Both densifies take the form
    the level-1 ``k_row`` picks (``_densify_onehot``), as the reference's
    one ``densify``. Zeroing the selection is the reference's ``pod_mean -
    pod_sel`` at every finite entry: x - x is +0.0, and the (-0.0, 0) pads
    are left out of the zeroing as they are no-ops in the subtraction.
    ``level_bytes`` (a dict) adds this worker's realized bytes per level:
    the intra-pod message, and the cross-pod message as the repack
    transport ships it when ``cfg.repack`` (``repack_transport``,
    inline)."""
    value_dtype = getattr(torch, cfg.value_dtype)
    rows, k_row = vals.shape
    onehot = _densify_onehot(cfg, k_row)
    cols = memory.shape[col_axis]
    gv, gi = _exchange(cfg, vals, idx, cols, layout.data_group)
    if level_bytes is not None:
        level_bytes["intra"] += enc.message_nbytes(
            rows, cols, k_row, cfg.value_dtype, cfg.wire)
    del vals, idx
    pod_mean = torch.zeros((rows, cols), dtype=value_dtype,
                           device=memory.device)
    pvals, pidx = _pod_mean_select(cfg, pod_mean, gv, gi, k_row, k_pod)
    del gv, gi
    n_live = k_pod
    if k_live is not None:
        pvals, pidx = mask_live_k(pvals, pidx, k_live)
        n_live = k_live
    # the residual, kept in memory: identical on every worker of the pod
    residual = pod_mean.scatter_(
        1, pidx[:, :n_live].to(torch.int64), 0.0)
    memory.movedim(col_axis, -1).add_(
        residual.view(memory.movedim(col_axis, -1).shape))
    del residual, pod_mean
    if cfg.wire == "packed":
        w2 = enc.WireSpec(rows, cols, k_pod, cfg.value_dtype)
        buf = enc.encode(w2, pvals, pidx, live_n=k_live)
        # cfg.repack: the compaction point before the slow link, the
        # identity inside the step
        if level_bytes is not None:
            level_bytes["cross"] += (
                repack_transport(w2, buf, live_n=k_live)[1] if cfg.repack
                else w2.nbytes)
        av, ai = _decode_packed(_gather_buf(buf, layout.pod_group), w2)
    else:
        if level_bytes is not None:
            level_bytes["cross"] += enc.message_nbytes(
                rows, cols, n_live if cfg.repack else k_pod,
                cfg.value_dtype, cfg.wire)
        av, ai = _gather_pairs(pvals, pidx, layout.pod_group)
    del pvals, pidx
    out = torch.zeros_like(memory, dtype=value_dtype)
    return _densify_update(out, col_axis, av, ai, k_pod, onehot)


def _row_topk_method(cfg: SyncConfig, k_row: int) -> str:
    """The ``kernels.row_topk`` method for one leaf or pod re-select (the
    reference's ``_pick_selection``, whose rule it keeps): ``argmax_onehot``
    is the loop up to ``argmax_k_limit`` and the threshold above it,
    ``threshold_onehot`` the loop up to the device's cutover and the
    threshold above it ("auto"), ``topk_scatter`` the threshold."""
    if cfg.selection == "threshold_onehot":
        return "auto"
    if cfg.selection == "argmax_onehot" and k_row <= cfg.argmax_k_limit:
        return "loop"
    return "threshold"


def _flatten_with(treedef, tree, n: int):
    return [None] * n if tree is None else treedef.flatten_up_to(tree)


def sparse_sync_gradients(cfg: SyncConfig, memory_tree, grad_tree, eta,
                          col_axes=None, *, layout=None):
    """PARALLEL-MEM-SGD gradient exchange on a parameter tree, leaf by leaf.

    ``memory_tree``: this worker's float32 memory, one tensor of each
    leaf's shape. ``eta``: a number. ``col_axes``: tree of ints (None: the
    last axis), the axis each leaf selects along
    (``repro_torch.launch.sharding.sync_col_axes``). ``layout``: the
    ``launch.mesh.Layout`` the two-level chain gathers over (needed with
    the hierarchical strategy and a pod axis; None: the flat default
    group).

    Per leaf: u = m + eta*g (two float32 ops, eta rounded to float32
    once). A leaf below ``dense_below`` entries, or every leaf under
    ``strategy="dense"``, ships all of u. Any other leaf hands the kernel
    its rows with the column axis last, contiguous (a copy when the axis
    was not last, freed once selected), selects k = ``k_for(C)`` pairs per
    row with ``kernels.row_topk``, keeps u with its own selected entries
    zeroed as its memory (the reference's u - own, up to the sign of zero
    there), sends the pairs over the wire and scatters every worker's
    pairs back through the moved view into a tensor in the parameter's
    own layout as the update (in ``value_dtype``, / W, back to float32).
    The two-level chain re-selects the pod mean at ``pod_k_for(C)`` and
    adds the pod residual to the memory (static pod k only, as the
    reference's per-leaf path).

    Returns (update_tree [float32, SUBTRACT from params], new_memory_tree,
    bytes_per_worker_per_step). Every returned leaf has the layout of its
    memory and gradient leaves (contiguous when they are), whatever its
    column axis, so the memory's layout does not drift from step to step.
    """
    cfg.validate()
    layout = _two_level_layout(cfg, layout)
    eta = eta32(eta)
    leaves_g, treedef = tree_flatten(grad_tree)
    leaves_m = treedef.flatten_up_to(memory_tree)
    leaves_c = _flatten_with(treedef, col_axes, len(leaves_g))
    ups, mems = [], []
    total = 0
    for m, g, c in zip(leaves_m, leaves_g, leaves_c):
        u = torch.add(m, torch.mul(g.to(m.dtype), eta))
        if cfg.strategy == "dense" or u.numel() < cfg.dense_below:
            ups.append(_mean(u))  # own = u
            mems.append(u - u)
            total += u.numel() * u.element_size()
            continue
        ca = (c if c is not None else u.dim() - 1) % u.dim()
        moved = u.movedim(ca, -1)
        lead, C = moved.shape[:-1], moved.shape[-1]
        rows = moved.reshape(-1, C).contiguous()
        k_row = cfg.k_for(C)
        vals, idx = row_topk(rows, k_row,
                             method=_row_topk_method(cfg, k_row))
        del rows
        # memory = u - own: u (this leaf's own tensor) with this worker's
        # selected entries zeroed, as the fused kernel forms it
        moved.scatter_(-1, idx.to(torch.int64).view(*lead, k_row), 0.0)
        if layout is not None:
            ups.append(_two_level_update(cfg, layout, u, ca, vals, idx,
                                         cfg.pod_k_for(C)))
        else:
            ups.append(_flat_update(cfg, u, ca, vals, idx))
        mems.append(u)
        total += _sparse_leaf_bytes(cfg, u.numel() // C, C)
        del u, moved, vals, idx
    return treedef.unflatten(ups), treedef.unflatten(mems), total


def bucketed_sync_gradients(
    cfg: SyncConfig,
    plan: bk.BucketPlan,
    memory_bufs,
    grad_tree,
    eta,
    *,
    layout=None,
    pod_ks: Optional[Sequence[int]] = None,
    level_bytes: Optional[dict] = None,
):
    """PARALLEL-MEM-SGD gradient exchange over flat buckets.

    ``memory_bufs``: this worker's float32 (rows, cols) memory, one per
    bucket. ``eta``: a number. ``layout``: as ``sparse_sync_gradients``'.

    The two-level chain's pod k is each bucket's ``pod_k_for_bucket``; with
    ``cfg.pod_dynamic``, ``pod_ks`` (one host int per bucket) gives each
    bucket's live pod k, clipped to [1, ``pod_k_max_for_bucket``], and
    every buffer, wire message and gather keeps that static k_max shape.
    ``level_bytes`` (a dict with "intra" and "cross") adds the bytes this
    worker's messages realized at each level (``_two_level_update``; a
    dense bucket counts its buffer at both levels, as the accounting).

    Returns (update_tree [float32 views into the update buffers, SUBTRACT
    from params], new_memory_bufs, bytes_per_worker_per_step:
    ``bucketed_message_bytes`` at the layout's n_data, the padded gathers
    at the static k).
    """
    cfg.validate(plan)
    layout = _two_level_layout(cfg, layout)
    if cfg.pod_dynamic and pod_ks is None:
        raise ValueError(
            "SyncConfig.pod_dynamic needs pod_ks (one live pod k per "
            "bucket), or unset pod_dynamic for static pod ratios")
    g_bufs = bk.pack(plan, grad_tree, dtype=torch.float32)
    ups, mems = [], []
    for b, (spec, m) in enumerate(zip(plan.buckets, memory_bufs)):
        # each packed gradient is dropped once consumed, so that the
        # bucket's update can take its block (a 2.75e9-element bucket
        # holds 10.3 GiB)
        g, g_bufs[b] = g_bufs[b], None
        if cfg.strategy == "dense" or spec.kind == "dense":
            u = torch.add(m, torch.mul(g, eta32(eta)))
            ups.append(_mean(u))  # own = u
            mems.append(u - u)
            if level_bytes is not None:
                nb = spec.rows * spec.cols * 4
                level_bytes["intra"] += nb
                level_bytes["cross"] += nb if layout is not None else 0
            continue
        k_row = cfg.k_for(spec.cols)
        new_m, vals, idx = fused_memsgd_update(m, g, eta, k_row)
        del g
        if layout is not None:
            k_live = None
            if cfg.pod_dynamic:
                k_pod = cfg.pod_k_max_for_bucket(b, spec.cols, layout.n_data)
                k_live = min(max(int(pod_ks[b]), 1), k_pod)
            else:
                k_pod = cfg.pod_k_for_bucket(b, spec.cols)
            ups.append(_two_level_update(cfg, layout, new_m, 1, vals, idx,
                                         k_pod, k_live, level_bytes))
        else:
            ups.append(_flat_update(cfg, new_m, 1, vals, idx))
            if level_bytes is not None:
                level_bytes["intra"] += _sparse_leaf_bytes(cfg, spec.rows,
                                                           spec.cols)
        mems.append(new_m)
        del vals, idx
    total = bucketed_message_bytes(
        cfg, plan, n_data=layout.n_data if layout is not None else None)
    return bk.unpack(plan, ups), tuple(mems), total


def repack_transport(wspec: enc.WireSpec, buf: torch.Tensor, link=None,
                     live_n: Optional[int] = None):
    """The transport half of the header-aware repack, inline: compact a
    k-padded wire buffer to its live payload (``encoding.repack``; its
    live count from ``live_n`` or the buffer's header) and re-expand it to
    the padded layout (``encoding.repad``, bit for bit the buffer that
    went in). Returns ``(padded_buf, wire_nbytes)``, the bytes the
    compacted message ships. The reference's ``link=`` form, which hands
    the small buffer to an emulated link, belongs to the host pipeline,
    which is not ported."""
    if link is not None:
        raise NotImplementedError(
            "repack_transport's link= form (the host pipeline) is not "
            "ported to the PyTorch port yet")
    small_spec, small_buf = enc.repack(wspec, buf, live_n)
    return enc.repad(wspec, small_spec, small_buf), small_spec.nbytes


def _sparse_leaf_bytes(cfg: SyncConfig, rows: int, cols: int,
                       pod_k: Optional[int] = None) -> int:
    """Exact per-worker bytes one sparse leaf or bucket puts on the wire
    per gather stage: the packed buffer or the (value_dtype, int32) pair
    arrays, at k_row and, for the two-level chain, at the pod k."""
    ks = [cfg.k_for(cols)]
    if cfg.strategy == "hierarchical" and cfg.pod_axis is not None:
        ks.append(pod_k if pod_k is not None else cfg.pod_k_for(cols))
    return sum(enc.message_nbytes(rows, cols, k, cfg.value_dtype, cfg.wire)
               for k in ks)


def autotune_pod_ratios(cfg: SyncConfig, plan, u_bufs, n_data: int,
                        mass_target: Optional[float] = None,
                        k_caps: Optional[Sequence[int]] = None) -> tuple:
    """Per-bucket pod re-compression ratios from realized mass capture:
    per sparse bucket the smallest k whose top-k captures
    ``cfg.pod_mass_target`` (or ``mass_target``) of the mass the pod
    stage can see (its support, ``n_data * k_row``), clamped to [k_min,
    support] and to ``k_caps``; ratio = k / cols, dense buckets 1.0.

    ``u_bufs``: per-bucket u = m + eta*g buffers, ``(n_shards, rows,
    cols)`` per-shard stacks (the pod stage is simulated:
    ``buckets.simulate_pod_mean``) or ``(rows, cols)`` (a global buffer,
    or the pod mean already formed). The mass-target mode of
    ``core.budget.BudgetController``, which it delegates to."""
    from repro_torch.core.budget import BudgetController

    ctl = BudgetController(cfg, plan, n_data, k_caps=k_caps)
    ks = ctl.allocate_mass_target(ctl.measure(u_bufs), mass_target)
    return ctl.ratios_of(ks)


def bucketed_message_bytes(cfg: SyncConfig, plan: bk.BucketPlan, *,
                           by_level: bool = False,
                           n_data: Optional[int] = None,
                           pod_ks: Optional[Sequence[int]] = None):
    """Per-worker per-step bytes the sync puts on the wire for a plan: the
    dense buckets' float32 buffers, and each sparse bucket's pairs, as the
    packed buffer or the unpacked (value_dtype values, int32 indices)
    arrays.

    ``by_level=True`` returns ``{"intra", "cross", "total"}`` on a (pod,
    data) layout: the two-level chain's level-1 message stays in the pod
    and only its pod-k summary crosses; a flat strategy's pod-axis gather
    re-ships the concatenated data-axis buffer, ``n_data`` messages
    (pass ``n_data``); a dense bucket moves its buffer at each level.
    ``total`` is the sum of the messages this worker emits.

    With ``cfg.pod_dynamic`` the level-2 message is k-padded: with
    ``n_data`` the default counts the padded gather
    (``pod_k_max_for_bucket``); ``pod_ks`` (the live per-bucket ks)
    counts what the repack transport ships instead."""
    cfg.validate(plan)
    if by_level and cfg.pod_axis is not None and n_data is None and (
            cfg.strategy not in ("hierarchical", "dense")):
        raise ValueError(
            "by_level accounting for a flat strategy on a pod layout needs "
            "n_data (the concatenated data-axis buffer is what crosses the "
            "pod boundary)")
    if (cfg.pod_dynamic and cfg.strategy == "hierarchical"
            and cfg.pod_axis is not None and pod_ks is None
            and n_data is None):
        raise ValueError(
            "pod-dynamic accounting needs n_data (the padded gather is "
            "shaped at the n_data-dependent k_max) or pod_ks (the live "
            "per-bucket ks, for effective-transport bytes)")
    intra = cross = total = 0
    pod = cfg.pod_axis is not None
    for b, spec in enumerate(plan.buckets):
        if cfg.strategy == "dense" or spec.kind == "dense":
            nb = spec.rows * spec.cols * 4
            total += nb
            intra += nb
            cross += nb if pod else 0
        elif cfg.strategy == "hierarchical" and pod:
            if pod_ks is not None:
                k2 = max(1, min(int(pod_ks[b]), spec.cols))
            elif cfg.pod_dynamic:
                k2 = cfg.pod_k_max_for_bucket(b, spec.cols, n_data)
            else:
                k2 = cfg.pod_k_for_bucket(b, spec.cols)
            lvl1, lvl2 = (enc.message_nbytes(spec.rows, spec.cols, k,
                                             cfg.value_dtype, cfg.wire)
                          for k in (cfg.k_for(spec.cols), k2))
            total += lvl1 + lvl2
            intra += lvl1
            cross += lvl2
        else:
            msg = _sparse_leaf_bytes(cfg, spec.rows, spec.cols)
            total += msg
            intra += msg
            if pod and n_data is not None:
                cross += n_data * msg
    if by_level:
        return {"intra": intra, "cross": cross, "total": total}
    return total


def message_bytes(cfg: SyncConfig, params, col_axes=None) -> int:
    """Per-worker per-step bytes the per-leaf sync puts on the wire for a
    parameter tree (tensors, ``meta`` tensors included): a dense leaf's
    float32 values, a sparse leaf's k = ``k_for(C)`` pairs per row of its
    column axis (and its pod-k summary on the two-level chain), as the
    packed buffer or the unpacked (value_dtype values, int32 indices)
    arrays."""
    cfg.validate()
    leaves, treedef = tree_flatten(params)
    total = 0
    for p, c in zip(leaves, _flatten_with(treedef, col_axes, len(leaves))):
        d = p.numel()
        if cfg.strategy == "dense" or d < cfg.dense_below:
            total += d * 4
            continue
        ca = (c if c is not None else p.dim() - 1) % max(p.dim(), 1)
        C = p.shape[ca] if p.dim() else 1
        total += _sparse_leaf_bytes(cfg, d // max(C, 1), C)
    return total
