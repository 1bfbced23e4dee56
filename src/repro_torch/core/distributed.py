"""PARALLEL-MEM-SGD gradient sync (port of ``repro.core.distributed``):
the bucketed path and the per-leaf path, flat or two-level.

Each data-parallel worker w:

  1. holds its own error-feedback memory m_w (paper Algorithm 2),
  2. forms u_w = m_w + eta * g_w for its local gradient g_w,
  3. selects ROW-BLOCK top-k (values, indices) per bucket or leaf row,
  4. exchanges only those pairs (all-gather over the workers),
  5. scatters the W*k received pairs into a dense update and divides by W,
  6. keeps m_w' = u_w - own_selection.

Each bucket or leaf is a chain of stages, the reference's: a sparse one's
``_sparse_stages`` E (select, encode), G (gather), D (decode, densify, /
W); a dense one's ``_dense_stages``, one comm stage (the mean
all-reduce). The chains run through ``core.pipeline.run_schedule`` at
``SyncConfig.overlap_depth()``: at ``overlap=None`` bucket after bucket,
each collective waited right after its issue (the synchronous op
sequence); at ``False`` the strict sequential plan (in eager PyTorch the
same order); at ``True`` the double buffer, bucket b's gather in flight
(``async_op=True``; its work handle and buffers held in a
``pipeline.Pending``) while bucket b+1 selects and encodes. Every
collective is issued in the planner's order, the same on every rank, and
every value is computed by the same ops at every depth, so the three
modes give the same bits.
``bucketed_sync_gradients`` runs steps 2, 3 and 6 as one fused CUDA
kernel per sparse bucket (``kernels.fused_memsgd_update``, its branch
resolved from k by ``method="auto"``, from the fused kernel's own measured
cutover on the card): its residual m' is
the reference's ``u - own`` (up to the sign of zero at selected entries).
``sparse_sync_gradients``, the per-leaf path (the train CLI's default),
forms u per leaf in its E stage, moves the leaf's column axis last and selects with
``kernels.row_topk``: the reference's ``selection`` variants exist for
XLA's partitioner, and in the port each maps to a top-k method of one
contract (``_row_topk_method``).

The two-level sync (``strategy="hierarchical"`` with a ``pod_axis``, on a
``launch.mesh.Layout`` of (pod, data) process groups; the reference's
``_hier_stages``: E1, G1, M, R, G2, D): the workers' pairs gather inside their pod at k_row,
each worker densifies the pod mean, re-selects it at the bucket's pod k
(``kernels.row_topk``) and keeps the pod residual (the pod mean less what
it selected) in its memory; only that summary gathers across the pods,
and the update is its densified mean over the pods. With
``pod_dynamic`` the pod k is a live host int per bucket (``pod_ks``):
every shape, wire buffer and gather stays at the static ceiling
``pod_k_max_for_bucket`` and ``kernels.topk_select.mask_live_k`` pads the
tail with (-0.0, 0) no-ops, whose count the packed header carries. The
``repack`` boundary before the cross-pod gather (the R stage) is the
identity inside a step, as the reference's in-trace one, so the gather
ships the k_max-padded buffer; ``repack_transport`` is the transport's
half (inline, or over a host link with ``link=``;
``bucketed_message_bytes(pod_ks=)`` accounts it). A hierarchical sync without a pod axis is the flat chain.

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

Qsparse-local-SGD (the ``qsparse_local`` preset): ``WireConfig.quant`` = s
adds a Q stage after each select (``_sparse_stages``, ``_hier_stages``):
the selection is QSGD-quantized (``optim.qsgd.quantize_rows``) on the
noise of a ``QuantNoise`` (level 1: the worker's own, level 2: its pod's),
the memory keeps the quantization error (``vals - deq`` at the selected
entries, the reference's ``u - own`` with ``own`` dequantized), and the
wire ships the codes and row norms (packed) or the dequantized values
(unpacked), so both give the same bits. ``local_steps`` = H is the train
step's: H - 1 local steps fold eta_t * g_t into a bucket-space
accumulator (``buckets.accumulate_local``) and the H-th syncs m + acc
through ``bucketed_sync_gradients(grad_bufs=)`` at eta 1.0;
``amortized_bytes_per_step`` is a step's share of the sync's bytes.

What the port runs: the ``sparse_allgather``, ``hierarchical`` and
``dense`` strategies, both wires, float32 or bf16 wire values (flat and
two-level: the bf16 pod mean is re-selected by the bf16 row top-k
kernels, or on its float32 keys where the reference's argmax loop keeps
them), the quantized tier, local steps, any number of workers, and every
preset of the reference's, at every ``overlap``.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import buckets as bk
from repro_torch.core import encoding as enc
from repro_torch.core import pipeline
from repro_torch.kernels import fused_memsgd_update, row_topk
from repro_torch.kernels.ref import eta32
from repro_torch.kernels.topk_select import mask_live_k
from repro_torch.utils.platform import TOPK_LOOP_CUTOVER
from repro_torch.utils.tree import tree_flatten

STRATEGIES = ("sparse_allgather", "hierarchical", "dense")
SELECTIONS = ("topk_scatter", "argmax_onehot", "threshold_onehot")
VALUE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class PodConfig:
    """The two-level (pod-aware) half of a ``SyncConfig``: the pod
    re-compression ratio (None: the sync's ``ratio``), per-bucket ratios
    index-aligned with the bucket plan (``autotune_pod_ratios``), the
    autotune's mass-capture target, the runtime pod k (bucketed only), a
    cap on its static padded k as a fraction of cols, and the pod axis
    (the launcher sets "pod" on a layout of more than one pod)."""

    ratio: Optional[float] = None
    ratios: Optional[Tuple[float, ...]] = None
    mass_target: float = 0.9
    dynamic: bool = False
    k_max_ratio: Optional[float] = None
    axis: Optional[str] = None

    def __post_init__(self):
        if self.ratios is not None and not isinstance(self.ratios, tuple):
            object.__setattr__(self, "ratios", tuple(self.ratios))


@dataclasses.dataclass(frozen=True)
class WireConfig:
    """What one sync message looks like on the wire: ``"unpacked"`` (the
    value_dtype values and int32 indices) or ``"packed"``
    (``core.encoding``), the wire's value dtype, and ``quant``: QSGD's
    s-level stochastic quantization of the selected values
    (Qsparse-local-SGD's Q step). Every sync stage quantizes before its
    encode, the sender's own contribution uses the DEQUANTIZED values, so
    the error-feedback memory absorbs the quantization error, and the
    packed wire ships ``1 + ceil(log2(quant+1))``-bit codes and one f32
    row norm (``encoding.WireSpec(quant=)``). None: exact values."""

    wire: str = "unpacked"
    value_dtype: str = "float32"
    quant: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """How sync messages move and are budgeted: the header-aware repack
    boundary before the cross-pod gather (the identity inside a step), the
    cross-pod byte budget per step per worker that
    ``core.budget.BudgetController`` water-fills, and the bucket
    pipeline's schedule (``core.pipeline``: None the plain
    bucket-after-bucket emission, False depth 1, True the double
    buffer)."""

    repack: bool = False
    byte_budget: Optional[int] = None
    overlap: Optional[bool] = None


# a flat SyncConfig keyword -> (its group, its name there), the
# reference's _FLAT_TO_GROUP
_FLAT_TO_GROUP = {
    "pod_ratio": ("pod", "ratio"),
    "pod_ratios": ("pod", "ratios"),
    "pod_mass_target": ("pod", "mass_target"),
    "pod_dynamic": ("pod", "dynamic"),
    "pod_k_max_ratio": ("pod", "k_max_ratio"),
    "pod_axis": ("pod", "axis"),
    "wire": ("wire_cfg", "wire"),
    "value_dtype": ("wire_cfg", "value_dtype"),
    "quant": ("wire_cfg", "quant"),
    "repack": ("transport", "repack"),
    "byte_budget": ("transport", "byte_budget"),
    "overlap": ("transport", "overlap"),
}


@dataclasses.dataclass(frozen=True, init=False)
class SyncConfig:
    """How gradients are synchronized across the data-parallel workers
    (the reference's ``SyncConfig``, its fields, defaults and groups).

    The pod knobs live in ``cfg.pod`` (``PodConfig``), the message format
    in ``cfg.wire_cfg`` (``WireConfig``), the transport and schedule in
    ``cfg.transport`` (``TransportConfig``)::

        SyncConfig(strategy="hierarchical", bucketed=True,
                   pod=PodConfig(dynamic=True, axis="pod"),
                   wire=WireConfig(wire="packed"),
                   transport=TransportConfig(repack=True))

    or ``SyncConfig.preset(name)``. Flat reads (``cfg.pod_dynamic``,
    ``cfg.wire``, ``cfg.quant``, ...) are properties; flat construction
    keywords (``SyncConfig(wire="packed")``, and ``dataclasses.replace``
    with a flat name) still parse into the groups under a
    ``DeprecationWarning``, as the reference's. ``with_pod``,
    ``with_wire`` and ``with_transport`` edit a group without one.

    ``local_steps`` = H > 1 is Qsparse-local-SGD: H uncommunicated steps
    accumulate u = sum_h eta_h * g_h in bucket space
    (``buckets.accumulate_local``), then one sync of m + acc; bytes per
    step fall by H (``amortized_bytes_per_step``). The reference's
    ``data_axes``, ``layout`` and ``constrain_intermediates`` serve its
    partitioner and have no counterpart: with no model axis (each worker
    holds whole tensors) every layout selects over the same rows."""

    strategy: str = "sparse_allgather"  # | "hierarchical" | "dense"
    ratio: float = 0.001  # per-row k_row = max(k_min, ratio * row_len)
    k_min: int = 1
    k_max: Optional[int] = None
    local_steps: int = 1
    dense_below: int = 16_384  # smaller leaves sync densely
    # the reference's selection implementations; every one gives the same
    # contract. The bucketed path runs each on the fused kernel; the
    # per-leaf path and the pod re-select map each to a top-k method
    # (_row_topk_method)
    selection: str = "argmax_onehot"
    argmax_k_limit: int = 64  # argmax_onehot takes the threshold above it
    bucketed: bool = False  # False: the per-leaf path
    bucket_cols: int = 1024
    pod: PodConfig = PodConfig()
    wire_cfg: WireConfig = WireConfig()
    transport: TransportConfig = TransportConfig()

    def __init__(self, strategy: str = "sparse_allgather",
                 ratio: float = 0.001, k_min: int = 1,
                 k_max: Optional[int] = None, local_steps: int = 1,
                 dense_below: int = 16_384, selection: str = "argmax_onehot",
                 argmax_k_limit: int = 64, bucketed: bool = False,
                 bucket_cols: int = 1024, pod: Optional[PodConfig] = None,
                 wire: Union[WireConfig, str, None] = None,
                 transport: Optional[TransportConfig] = None,
                 wire_cfg: Optional[WireConfig] = None, _warn: bool = True,
                 **legacy):
        # wire= is both the grouped keyword (a WireConfig) and the flat
        # format string; wire_cfg= is the field's own name (what
        # dataclasses.replace passes back)
        if isinstance(wire, WireConfig):
            if wire_cfg is not None:
                raise TypeError(
                    "pass either wire=WireConfig(...) or wire_cfg=, not both")
            wire_cfg, wire = wire, None
        if wire is not None:
            legacy["wire"] = wire
        unknown = set(legacy) - set(_FLAT_TO_GROUP)
        if unknown:
            raise TypeError(
                f"SyncConfig got unexpected argument(s) {sorted(unknown)}")
        if legacy and _warn:
            warnings.warn(
                f"flat SyncConfig keyword(s) {sorted(legacy)} are deprecated; "
                "use the grouped pod=PodConfig(...)/wire=WireConfig(...)/"
                "transport=TransportConfig(...) fields or "
                "SyncConfig.preset(...)", DeprecationWarning, stacklevel=2)
        groups = {"pod": pod if pod is not None else PodConfig(),
                  "wire_cfg": wire_cfg if wire_cfg is not None
                  else WireConfig(),
                  "transport": transport if transport is not None
                  else TransportConfig()}
        over = {g: {} for g in groups}
        for k, v in legacy.items():
            grp, name = _FLAT_TO_GROUP[k]
            over[grp][name] = v
        for grp, kw in over.items():
            if kw:
                groups[grp] = dataclasses.replace(groups[grp], **kw)
        for name, v in (("strategy", strategy), ("ratio", ratio),
                        ("k_min", k_min), ("k_max", k_max),
                        ("local_steps", int(local_steps)),
                        ("dense_below", dense_below), ("selection", selection),
                        ("argmax_k_limit", argmax_k_limit),
                        ("bucketed", bucketed), ("bucket_cols", bucket_cols),
                        *groups.items()):
            object.__setattr__(self, name, v)

    # -- flat reads ---------------------------------------------------------

    pod_ratio = property(lambda self: self.pod.ratio)
    pod_ratios = property(lambda self: self.pod.ratios)
    pod_mass_target = property(lambda self: self.pod.mass_target)
    pod_dynamic = property(lambda self: self.pod.dynamic)
    pod_k_max_ratio = property(lambda self: self.pod.k_max_ratio)
    pod_axis = property(lambda self: self.pod.axis)
    wire = property(lambda self: self.wire_cfg.wire)
    value_dtype = property(lambda self: self.wire_cfg.value_dtype)
    quant = property(lambda self: self.wire_cfg.quant)
    repack = property(lambda self: self.transport.repack)
    byte_budget = property(lambda self: self.transport.byte_budget)
    overlap = property(lambda self: self.transport.overlap)

    # -- grouped edits without a warning ------------------------------------

    def with_pod(self, **kw) -> "SyncConfig":
        """``self`` with fields of ``self.pod`` replaced."""
        return dataclasses.replace(
            self, pod=dataclasses.replace(self.pod, **kw))

    def with_wire(self, **kw) -> "SyncConfig":
        """``self`` with fields of ``self.wire_cfg`` replaced."""
        return dataclasses.replace(
            self, wire_cfg=dataclasses.replace(self.wire_cfg, **kw))

    def with_transport(self, **kw) -> "SyncConfig":
        """``self`` with fields of ``self.transport`` replaced."""
        return dataclasses.replace(
            self, transport=dataclasses.replace(self.transport, **kw))

    @classmethod
    def preset(cls, name: str, **overrides) -> "SyncConfig":
        """A known-good bundle of the reference's (``SyncConfig.preset``),
        with ``overrides`` on top (flat keywords edit single fields, without
        a warning; grouped ones replace a whole group):

        * ``"dense"``         — vanilla data-parallel all-reduce.
        * ``"topk"``          — the paper's Mem-SGD: bucketed top-k over the
          packed wire.
        * ``"qsparse_local"`` — Qsparse-local-SGD: 4 local steps, top-k and
          15-level stochastic quantization, packed wire.
        * ``"pod_budgeted"``  — the two-level pod sync with runtime pod k
          and the repack boundary (give it ``byte_budget=`` to water-fill;
          the launcher sets ``pod_axis`` from the layout).
        """
        try:
            merged = dict(_PRESETS[name])
        except KeyError:
            raise ValueError(
                f"unknown SyncConfig preset {name!r}; available: "
                f"{sorted(_PRESETS)}") from None
        for k, v in overrides.items():
            merged["wire_cfg" if k == "wire" and isinstance(v, WireConfig)
                   else k] = v
        return cls(_warn=False, **merged)

    def validate(self, plan=None) -> "SyncConfig":
        """Raise a named ``ValueError`` (the reference's) for an unknown
        value or an illegal combination. With the bucket ``plan``, also
        check that ``pod_ratios`` is aligned with it."""
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
        if self.local_steps > 1 and not self.bucketed:
            raise ValueError(
                "SyncConfig.local_steps > 1 requires the bucketed engine "
                "(bucketed=True): the local-step accumulator lives in "
                "bucket space")
        if self.quant is not None:
            if self.quant < 1:
                raise ValueError(
                    f"WireConfig.quant must be >= 1 levels, got {self.quant}")
            if self.strategy == "dense":
                raise ValueError(
                    "WireConfig.quant composes with the sparse selections; "
                    "the dense all-reduce strategy has no quantize stage")
            if not self.bucketed:
                raise ValueError(
                    "WireConfig.quant requires the bucketed engine "
                    "(bucketed=True): quantization is defined on the "
                    "(rows, cols) bucket layout")
            if self.value_dtype != "float32":
                raise ValueError(
                    "WireConfig.quant replaces the value dtype on the wire "
                    "(codes + f32 row norms); combining it with "
                    f"value_dtype={self.value_dtype!r} would quantize "
                    "already-rounded values")
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
        if plan is not None:
            validate_pod_ratios(self, plan)
        return self

    def overlap_depth(self) -> Optional[int]:
        """The bucket pipeline's depth for ``overlap``
        (``pipeline.overlap_depth``)."""
        return pipeline.overlap_depth(self.overlap)

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


# the reference's bundles (its _PRESETS)
_PRESETS = {
    "dense": dict(strategy="dense"),
    "topk": dict(strategy="sparse_allgather", bucketed=True,
                 wire_cfg=WireConfig(wire="packed")),
    "qsparse_local": dict(strategy="sparse_allgather", bucketed=True,
                          local_steps=4,
                          wire_cfg=WireConfig(wire="packed", quant=15)),
    "pod_budgeted": dict(strategy="hierarchical", bucketed=True,
                         wire_cfg=WireConfig(wire="packed"),
                         pod=PodConfig(dynamic=True),
                         transport=TransportConfig(repack=True)),
}


def distributed() -> bool:
    """Whether a torch.distributed group is initialised: the sync then
    gathers through it, whatever its size."""
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def world_size() -> int:
    """Data-parallel workers: the torch.distributed world, else 1."""
    return torch.distributed.get_world_size() if distributed() else 1


class _Work:
    """Collectives' work handles waited together (``wait()``), with the
    tensors they read kept referenced until then (a contiguous copy that
    no caller holds). No handle: the collective completed on issue."""

    def __init__(self, works=(), keep=()):
        self._works, self._keep = list(works), tuple(keep)

    def wait(self) -> bool:
        for w in self._works:
            w.wait()
        self._works, self._keep = [], ()
        return True


def _group_size(group=None) -> int:
    return torch.distributed.get_world_size(group) if distributed() else 1


def _all_gather_async(x: torch.Tensor, group=None):
    """Issue the all-gather of x over the group's members (the world
    without a ``group``) with ``async_op=True``: returns ``(out, work)``;
    once ``work.wait()`` returned, out, (n,) + x.shape, holds every
    member's x in the group's rank order. Without torch.distributed: x
    with a leading axis and a complete handle."""
    if not distributed():
        return x.unsqueeze(0), _Work()
    n = torch.distributed.get_world_size(group)
    flat = x.contiguous().view(-1)
    out = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
    work = torch.distributed.all_gather_into_tensor(out, flat, group=group,
                                                    async_op=True)
    return out.view((n,) + tuple(x.shape)), _Work([work], [flat])


def _all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``_all_gather_async``, waited: (n,) + x.shape."""
    out, work = _all_gather_async(x, group)
    work.wait()
    return out


def _mean_async(u: torch.Tensor, group=None):
    """Issue the sum all-reduce of a copy of u over the group's members
    (every worker without a ``group``) with ``async_op=True``: returns
    ``(out, work)``; once waited, ``_mean_of(out, group)`` is the mean (the
    reference's ``pmean``). Without torch.distributed: u itself and a
    complete handle."""
    if not distributed():
        return u, _Work()
    out = u.clone()
    work = torch.distributed.all_reduce(out, group=group, async_op=True)
    return out, _Work([work])


def _mean_of(out: torch.Tensor, group=None) -> torch.Tensor:
    """The waited sum of ``_mean_async`` / n, in place."""
    n = _group_size(group)
    return out.div_(n) if n > 1 else out


def _mean(u: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of u over the group's members, waited."""
    out, work = _mean_async(u, group)
    work.wait()
    return _mean_of(out, group)


def _gather_pairs_async(vals: torch.Tensor, idx: torch.Tensor, group=None):
    """Issue the gathers of (rows, k) pairs: ``((gv, gi), work)``, each
    (n, rows, k) in rank order once waited (``_tile`` lays them out)."""
    gv, wv = _all_gather_async(vals, group)
    gi, wi = _all_gather_async(idx, group)
    return (gv, gi), _Work([wv, wi])


def _tile(x: torch.Tensor) -> torch.Tensor:
    """Gathered (n, rows, k) -> (rows, n*k): the members' pairs tiled
    along the last axis in rank order (a copy: read it once waited)."""
    return x.movedim(0, 1).reshape(x.shape[1], -1)


def _gather_buf_async(buf: torch.Tensor, group=None):
    """Issue the gather of every member's wire buffer: ``(bufs, work)``,
    (n, words) uint32 in rank order once waited (the collective moves
    their int32 view)."""
    out, work = _all_gather_async(buf.view(torch.int32), group)
    return out.view(torch.uint32), work


def _decode_packed(bufs: torch.Tensor, wspec: enc.WireSpec):
    """(n, words) gathered buffers -> pairs (rows, n*k) in the tile order
    of ``_tile``, so the densify sees the unpacked wire's pairs."""
    vals, idx = zip(*(enc.decode(wspec, b) for b in bufs))
    tile = lambda xs: torch.stack(xs, 1).reshape(wspec.rows, -1)  # noqa
    return tile(vals), tile(idx)


def _wspec(cfg: "SyncConfig", rows: int, cols: int, k: int) -> enc.WireSpec:
    """The packed message layout of (rows, cols, k) pairs under ``cfg``:
    its value dtype and its quantized tier."""
    return enc.WireSpec(rows, cols, k, cfg.value_dtype, quant=cfg.quant)


def _nbytes(cfg: "SyncConfig", rows: int, cols: int, k: int) -> int:
    """``encoding.message_nbytes`` of (rows, cols, k) pairs under ``cfg``."""
    return enc.message_nbytes(rows, cols, k, cfg.value_dtype, cfg.wire,
                              quant=cfg.quant)


def _payload(cfg: "SyncConfig", vals: torch.Tensor, idx: torch.Tensor,
             cols: int, live_n: Optional[int] = None):
    """This worker's message of its (rows, k) pairs: the packed buffer
    (``live_n`` stamped into its header), or the (value_dtype values,
    int32 indices) arrays. ``vals`` under quant: the (norms, codes, deq)
    of ``_quantize_selected``; the packed wire ships the codes and norms,
    the unpacked one the dequantized values."""
    if cfg.quant is not None:
        norms, codes, vals = vals
        if cfg.wire == "packed":
            rows, k = codes.shape
            return enc.encode(_wspec(cfg, rows, cols, k), codes, idx,
                              live_n=live_n, norms=norms)
    if cfg.wire == "packed":
        rows, k = vals.shape
        return enc.encode(_wspec(cfg, rows, cols, k), vals, idx,
                          live_n=live_n)
    return vals.to(getattr(torch, cfg.value_dtype)), idx


def _issue_gather(cfg: "SyncConfig", payload, group=None):
    """Issue the gather of a ``_payload`` over the group: ``(got,
    work)``; ``_received`` reads ``got`` once waited."""
    if cfg.wire == "packed":
        return _gather_buf_async(payload, group)
    return _gather_pairs_async(*payload, group)


def _received(cfg: "SyncConfig", got, rows: int, cols: int, k: int):
    """What a waited ``_issue_gather`` received: every member's pairs,
    (rows, n*k) values in ``value_dtype`` and int32 indices, tiled in rank
    order (packed: decoded)."""
    if cfg.wire == "packed":
        return _decode_packed(got, _wspec(cfg, rows, cols, k))
    gv, gi = got
    return _tile(gv), _tile(gi)


def _exchange(cfg: "SyncConfig", vals: torch.Tensor, idx: torch.Tensor,
              cols: int, group=None):
    """The wire stages of one sparse bucket or leaf, waited: this worker's
    (rows, k) pairs -> every group member's, (rows, n*k) values in
    ``value_dtype`` and int32 indices. Packed: encode -> gather ->
    decode; unpacked: gather."""
    got, work = _issue_gather(cfg, _payload(cfg, vals, idx, cols), group)
    work.wait()
    return _received(cfg, got, vals.shape[0], cols, vals.shape[1])


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


def _u(m: torch.Tensor, g: torch.Tensor, eta: float) -> torch.Tensor:
    """u = m + eta*g: two float32 ops, ``eta`` rounded to float32."""
    return torch.add(m, torch.mul(g.to(m.dtype), eta))


def _gather_stage(cfg: "SyncConfig", group=None):
    """A chain's G stage: (memory, payload) -> ``Pending`` of (memory,
    what the group's gather received), the gather in flight until the
    bucket's next stage resolves it."""
    def gather(st):
        mem, payload = st
        got, work = _issue_gather(cfg, payload, group)
        return pipeline.Pending([work], lambda: (mem, got))
    return gather


def _dense_stages(eta: float):
    """The chain of one dense leaf or bucket (the reference's
    ``_dense_stages``): one comm stage, (m, g) -> u, then the mean
    all-reduce of u in flight; resolved, (update, memory): the mean, and
    u - own with own = u."""
    def allreduce(x):
        u = _u(*x, eta)
        out, work = _mean_async(u)
        own = u - u
        return pipeline.Pending([work], lambda: (_mean_of(out), own))
    return [allreduce], (pipeline.COMM,)


def _select_encode_stage(cfg: "SyncConfig", select, rows: int, cols: int,
                         k_row: int, level_bytes: Optional[dict] = None):
    """A chain's E (E1) stage: ``select`` (m, g) -> (memory, this
    worker's (rows, k_row) pairs), then the wire encode: (memory,
    payload). ``level_bytes`` adds the message's bytes to "intra"."""
    def select_encode(x):
        mem, vals, idx = select(*x)
        if level_bytes is not None:
            level_bytes["intra"] += _nbytes(cfg, rows, cols, k_row)
        return mem, _payload(cfg, vals, idx, cols)
    return select_encode


def _quantize_selected(cfg: "SyncConfig", vals: torch.Tensor, uniforms):
    """QSGD-quantize a (rows, k) selection on the given uniforms: (norms,
    codes, dequantized float32 values). The dequantized values are what
    every receiver decodes (``encoding.dequantize_rows``, the one shared
    formula), so a memory that keeps ``vals - deq`` absorbs exactly the
    quantization error that ships."""
    from repro_torch.optim.qsgd import quantize_rows

    norms, codes = quantize_rows(vals.to(torch.float32), cfg.quant, uniforms)
    return norms, codes, enc.dequantize_rows(norms, codes, cfg.quant)


def _keep_quant_error(mem: torch.Tensor, col_axis: int, idx: torch.Tensor,
                      vals: torch.Tensor, deq: torch.Tensor) -> None:
    """Into the memory of the selected entries (zeroed by the select),
    their quantization error ``vals - deq``, in place: the reference's
    ``u - own`` with ``own`` the densified dequantized selection, as
    ``vals`` is u there bit for bit."""
    moved = mem.movedim(col_axis, -1)
    lead = moved.shape[:-1]
    k = idx.shape[-1]
    moved.scatter_(-1, idx.to(torch.int64).reshape(*lead, k),
                   torch.sub(vals.to(torch.float32), deq).reshape(*lead, k)
                   .to(mem.dtype))


def _select_stage(select):
    """A quantized chain's E (E1) stage: ``select`` (m, g) -> (memory,
    vals, idx), the encode left to the Q stage."""
    return lambda x: select(*x)


def _quantize_encode_stage(cfg: "SyncConfig", col_axis: int, cols: int,
                           k_row: int, uniforms_of,
                           level_bytes: Optional[dict] = None):
    """A quantized chain's Q (Q1) stage: (memory, vals, idx) -> (memory,
    payload): the selection quantized on ``uniforms_of(shape, device)``,
    its quantization error kept in the memory (``_keep_quant_error``) and
    the quantized message encoded. ``level_bytes`` adds the message's
    bytes to "intra"."""
    def quantize_encode(st):
        mem, vals, idx = st
        q = _quantize_selected(cfg, vals, uniforms_of(vals.shape,
                                                      vals.device))
        _keep_quant_error(mem, col_axis, idx, vals, q[2])
        if level_bytes is not None:
            level_bytes["intra"] += _nbytes(cfg, vals.shape[0], cols, k_row)
        return mem, _payload(cfg, q, idx, cols)
    return quantize_encode


def _decode_stage(cfg: "SyncConfig", col_axis: int, rows: int, cols: int,
                  k: int, onehot: bool):
    """A chain's D stage: (memory, what a gather of k pairs a row
    received) -> (update, memory): the decode, and the densify into a
    tensor of the memory's layout (``col_axis`` its column axis), the
    mean over the gather's members, as float32."""
    def decode_apply(st):
        mem, got = st
        gv, gi = _received(cfg, got, rows, cols, k)
        out = torch.zeros_like(mem, dtype=getattr(torch, cfg.value_dtype))
        return _densify_update(out, col_axis, gv, gi, k, onehot), mem
    return decode_apply


def _sparse_stages(cfg: "SyncConfig", select, col_axis: int, rows: int,
                   cols: int, k_row: int, level_bytes: Optional[dict] = None,
                   uniforms_of=None):
    """The flat chain of one sparse leaf or bucket (the reference's
    ``_sparse_stages``): E, the select and the wire encode; G, the
    gather over every worker; D, the decode, the densify and / W. The
    final state is (update, memory).

    Under ``cfg.quant`` the encode moves to a Q stage after the select
    (kinds COMPUTE, QUANT, COMM, COMPUTE): the selection quantized on
    ``uniforms_of(shape, device)`` (this worker's level-1 noise), its
    error kept in the memory, the quantized message encoded."""
    decode = _decode_stage(cfg, col_axis, rows, cols, k_row,
                           _densify_onehot(cfg, k_row))
    if cfg.quant is not None:
        return ([_select_stage(select),
                 _quantize_encode_stage(cfg, col_axis, cols, k_row,
                                        uniforms_of, level_bytes),
                 _gather_stage(cfg), decode],
                (pipeline.COMPUTE, pipeline.QUANT, pipeline.COMM,
                 pipeline.COMPUTE))
    return ([_select_encode_stage(cfg, select, rows, cols, k_row,
                                  level_bytes),
             _gather_stage(cfg), decode],
            (pipeline.COMPUTE, pipeline.COMM, pipeline.COMPUTE))


def _hier_stages(cfg: "SyncConfig", layout, select, col_axis: int, rows: int,
                 cols: int, k_row: int, k_pod: int,
                 k_live: Optional[int] = None,
                 level_bytes: Optional[dict] = None, uniforms_of=None,
                 pod_uniforms_of=None):
    """The two-level chain of one sparse leaf or bucket (the reference's
    ``_hier_stages``):

      E1 (compute): the select at k_row, the level-1 encode
      G1 (comm):    the gather in the pod (the layout's data group)
      M  (compute): the level-1 decode, the pod mean (rows, cols), its
                    re-select at ``k_pod`` (``k_live`` live slots:
                    ``mask_live_k``), the pod residual (the pod mean with
                    the live selection zeroed) added into the memory in
                    place, the level-2 encode
      R  (repack):  only with ``cfg.repack``: the compaction point before
                    the slow link, the identity on the buffer inside the
                    step, as the reference's in-trace R
      G2 (comm):    the gather across the pods (the layout's pod group)
      D  (compute): the level-2 decode and its densified mean over the
                    pods, float32, in the memory's layout

    The final state is (update, memory). The pod mean, its re-select and
    the residual stay in ``value_dtype`` until the final cast (at bf16
    the re-select is the bf16 row top-k, or the float32 one on the
    reference's argmax keys: ``_pod_mean_select``; ``add_`` widens the
    residual into the float32 memory, as the reference's ``(u - own) +
    residual``). Both densifies take the form the level-1 ``k_row`` picks
    (``_densify_onehot``), as the reference's one ``densify``. Zeroing the
    selection is the reference's ``pod_mean - pod_sel`` at every finite
    entry: x - x is +0.0, and the (-0.0, 0) pads are left out of the
    zeroing as they are no-ops in the subtraction. ``level_bytes`` adds
    this worker's realized bytes per level: the intra-pod message, and
    the cross-pod message as the repack transport ships it when
    ``cfg.repack`` (``repack_transport``, counted at R).

    Under ``cfg.quant`` (kinds COMPUTE, QUANT, COMM, COMPUTE, QUANT,
    (REPACK,) COMM, COMPUTE): Q1 quantizes this worker's selection on
    ``uniforms_of`` (its own noise) and keeps the error in the memory; M
    stops at the re-select; Q2 quantizes the pod summary on
    ``pod_uniforms_of`` (the pod's noise, the same on each of its
    workers, so each keeps the same residual and ships the same codes)
    and leaves ``pvals - deq`` at the live slots of the pod residual, the
    reference's ``pod_mean - densify(deq)``."""
    value_dtype = getattr(torch, cfg.value_dtype)
    n_live = k_pod if k_live is None else k_live

    def pod_reselect(st):
        mem, got = st
        gv, gi = _received(cfg, got, rows, cols, k_row)
        del got
        pod_mean = torch.zeros((rows, cols), dtype=value_dtype,
                               device=mem.device)
        pvals, pidx = _pod_mean_select(cfg, pod_mean, gv, gi, k_row, k_pod)
        del gv, gi
        if k_live is not None:
            pvals, pidx = mask_live_k(pvals, pidx, k_live)
        return mem, pod_mean, pvals, pidx

    def keep_residual(mem, pod_mean, pidx, left):
        # the residual, kept in memory: identical on every worker of the
        # pod; ``left`` is what the live selection leaves of the pod mean
        residual = pod_mean.scatter_(
            1, pidx[:, :n_live].to(torch.int64), left)
        moved = mem.movedim(col_axis, -1)
        moved.add_(residual.view(moved.shape))
        if level_bytes is not None and not cfg.repack:
            level_bytes["cross"] += _nbytes(cfg, rows, cols, k_pod)

    def pod_reselect_encode(st):
        mem, pod_mean, pvals, pidx = pod_reselect(st)
        keep_residual(mem, pod_mean, pidx, 0.0)
        del pod_mean
        return mem, _payload(cfg, pvals, pidx, cols, live_n=k_live)

    def pod_quantize_encode(st):
        mem, pod_mean, pvals, pidx = st
        q = _quantize_selected(cfg, pvals, pod_uniforms_of(pvals.shape,
                                                           pvals.device))
        keep_residual(mem, pod_mean, pidx,
                      torch.sub(pvals, q[2])[:, :n_live].contiguous())
        del pod_mean
        return mem, _payload(cfg, q, pidx, cols, live_n=k_live)

    def repack_boundary(st):
        if level_bytes is not None:
            level_bytes["cross"] += (
                repack_transport(_wspec(cfg, rows, cols, k_pod), st[1],
                                 live_n=k_live)[1]
                if cfg.wire == "packed" else _nbytes(cfg, rows, cols,
                                                     n_live))
        return st

    if cfg.quant is not None:
        stages = [_select_stage(select),
                  _quantize_encode_stage(cfg, col_axis, cols, k_row,
                                         uniforms_of, level_bytes),
                  _gather_stage(cfg, layout.data_group), pod_reselect,
                  pod_quantize_encode]
        kinds = [pipeline.COMPUTE, pipeline.QUANT, pipeline.COMM,
                 pipeline.COMPUTE, pipeline.QUANT]
    else:
        stages = [_select_encode_stage(cfg, select, rows, cols, k_row,
                                       level_bytes),
                  _gather_stage(cfg, layout.data_group), pod_reselect_encode]
        kinds = [pipeline.COMPUTE, pipeline.COMM, pipeline.COMPUTE]
    if cfg.repack:
        stages.append(repack_boundary)
        kinds.append(pipeline.REPACK)
    stages += [_gather_stage(cfg, layout.pod_group),
               _decode_stage(cfg, col_axis, rows, cols, k_pod,
                             _densify_onehot(cfg, k_row))]
    kinds += [pipeline.COMM, pipeline.COMPUTE]
    return stages, tuple(kinds)


def _leaf_select(m: torch.Tensor, g: torch.Tensor, *, eta: float,
                 col_axis: int, k_row: int, method: str):
    """The per-leaf path's select: u = m + eta*g, its rows with the column
    axis last (a contiguous copy when the axis was not last, freed once
    selected), their top-k_row pairs (``kernels.row_topk``), and u with
    this worker's selected entries zeroed as its memory (the reference's u
    - own, up to the sign of zero there, as the fused kernel forms it).
    Returns (memory, vals, idx)."""
    u = _u(m, g, eta)
    moved = u.movedim(col_axis, -1)
    lead, C = moved.shape[:-1], moved.shape[-1]
    rows = moved.reshape(-1, C).contiguous()
    vals, idx = row_topk(rows, k_row, method=method)
    del rows
    moved.scatter_(-1, idx.to(torch.int64).view(*lead, k_row), 0.0)
    return u, vals, idx


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
    ``strategy="dense"``, ships all of u (``_dense_stages``). Any other
    leaf selects k = ``k_for(C)`` pairs per row along its column axis
    (``_leaf_select``), keeps u with its own selected entries zeroed as
    its memory, sends the pairs over the wire and scatters every worker's
    pairs back through the moved view into a tensor in the parameter's
    own layout as the update (in ``value_dtype``, / W, back to float32):
    ``_sparse_stages``. The two-level chain (``_hier_stages``) re-selects
    the pod mean at ``pod_k_for(C)`` and adds the pod residual to the
    memory (static pod k only, as the reference's per-leaf path). The
    leaves' chains run through ``pipeline.run_schedule`` at
    ``cfg.overlap_depth()``; every depth gives the same bits.

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
    inits, stage_lists, kind_lists = [], [], []
    total = 0
    for m, g, c in zip(leaves_m, leaves_g, leaves_c):
        inits.append((m, g))
        if cfg.strategy == "dense" or m.numel() < cfg.dense_below:
            stages, kinds = _dense_stages(eta)
            total += m.numel() * m.element_size()
        else:
            ca = (c if c is not None else m.dim() - 1) % m.dim()
            C = m.shape[ca]
            rows, k_row = m.numel() // C, cfg.k_for(C)
            select = functools.partial(
                _leaf_select, eta=eta, col_axis=ca, k_row=k_row,
                method=_row_topk_method(cfg, k_row))
            if layout is not None:
                stages, kinds = _hier_stages(cfg, layout, select, ca, rows,
                                             C, k_row, cfg.pod_k_for(C))
            else:
                stages, kinds = _sparse_stages(cfg, select, ca, rows, C,
                                               k_row)
            total += _sparse_leaf_bytes(cfg, rows, C)
        stage_lists.append(stages)
        kind_lists.append(kinds)
    outs = pipeline.run_schedule(inits, stage_lists, kind_lists,
                                 cfg.overlap_depth())
    return (treedef.unflatten([upd for upd, _ in outs]),
            treedef.unflatten([mem for _, mem in outs]), total)


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
    grad_bufs: Optional[Sequence[torch.Tensor]] = None,
    quant_noise=None,
    return_bufs: bool = False,
):
    """PARALLEL-MEM-SGD gradient exchange over flat buckets.

    ``memory_bufs``: this worker's float32 (rows, cols) memory, one per
    bucket. ``eta``: a number. ``layout``: as ``sparse_sync_gradients``'.

    A sparse bucket's E stage is the fused kernel
    (``kernels.fused_memsgd_update``: u, its row top-k and the residual
    memory in one pass); its chain is the flat one or, on a layout, the
    two-level one, whose pod k is each bucket's ``pod_k_for_bucket``;
    with ``cfg.pod_dynamic``, ``pod_ks`` (one host int per bucket) gives
    each bucket's live pod k, clipped to [1, ``pod_k_max_for_bucket``],
    and every buffer, wire message and gather keeps that static k_max
    shape. ``level_bytes`` (a dict with "intra" and "cross") adds the
    bytes this worker's messages realized at each level (``_hier_stages``;
    a dense bucket counts its buffer at both levels, as the accounting).

    ``grad_bufs`` (one float32 (rows, cols) buffer per bucket) stands for
    ``grad_tree``'s packing: the Qsparse-local-SGD step passes its
    H-step accumulator here, at ``eta`` 1.0 (the stepsizes are in it
    already, ``buckets.accumulate_local``). ``quant_noise``
    (``optim.qsgd.QuantNoise``, or an object with its ``uniforms``) is
    needed with ``cfg.quant``: bucket b's level-1 stage draws
    ``uniforms(b, 1, rank)`` (the worker's global rank), a two-level
    chain's level-2 stage ``uniforms(b, 2, pod)``.
    The buckets' chains run through ``pipeline.run_schedule`` at
    ``cfg.overlap_depth()``; each chain's input is its (memory, packed
    gradient) pair, and each packed gradient is dropped once its bucket's
    first stage consumed it, so that the bucket's update can take its
    block (a 2.75e9-element bucket holds 10.3 GiB).

    Returns (update_tree [float32 views into the update buffers, SUBTRACT
    from params], new_memory_bufs, bytes_per_worker_per_step:
    ``bucketed_message_bytes`` at the layout's n_data, the padded gathers
    at the static k). With ``return_bufs`` a fourth item follows: the
    update buffers themselves, one float32 (rows, cols) buffer per bucket
    (what ``launch.delta_stream.encode_delta_bufs`` encodes). Every sync
    makes them anew, in every overlap mode, so they stay valid after the
    next step.
    """
    cfg.validate(plan)
    layout = _two_level_layout(cfg, layout)
    if cfg.pod_dynamic and pod_ks is None:
        raise ValueError(
            "SyncConfig.pod_dynamic needs pod_ks (one live pod k per "
            "bucket), or unset pod_dynamic for static pod ratios")
    if cfg.quant is not None and quant_noise is None:
        raise ValueError(
            "WireConfig.quant needs quant_noise (an optim.qsgd.QuantNoise "
            "of the step): stochastic rounding must draw fresh noise every "
            "sync")
    if grad_bufs is not None:
        g_bufs = [g.to(torch.float32) for g in grad_bufs]
    else:
        g_bufs = bk.pack(plan, grad_tree, dtype=torch.float32)
    inits = list(zip(memory_bufs, g_bufs))
    del g_bufs
    rank = layout.rank if layout is not None else _rank()
    stage_lists, kind_lists = [], []
    for b, spec in enumerate(plan.buckets):
        noise = _noise_of(quant_noise, b, 1, rank)
        if cfg.strategy == "dense" or spec.kind == "dense":
            stages, kinds = _dense_stages(eta32(eta))
            if level_bytes is not None:
                nb = spec.rows * spec.cols * 4
                level_bytes["intra"] += nb
                level_bytes["cross"] += nb if layout is not None else 0
        else:
            k_row = cfg.k_for(spec.cols)
            select = functools.partial(fused_memsgd_update, eta=eta, k=k_row)
            if layout is not None:
                k_live = None
                if cfg.pod_dynamic:
                    k_pod = cfg.pod_k_max_for_bucket(b, spec.cols,
                                                     layout.n_data)
                    k_live = min(max(int(pod_ks[b]), 1), k_pod)
                else:
                    k_pod = cfg.pod_k_for_bucket(b, spec.cols)
                stages, kinds = _hier_stages(
                    cfg, layout, select, 1, spec.rows, spec.cols, k_row,
                    k_pod, k_live, level_bytes, noise,
                    _noise_of(quant_noise, b, 2, layout.pod))
            else:
                stages, kinds = _sparse_stages(
                    cfg, select, 1, spec.rows, spec.cols, k_row, level_bytes,
                    noise)
        stage_lists.append(stages)
        kind_lists.append(kinds)
    outs = pipeline.run_schedule(inits, stage_lists, kind_lists,
                                 cfg.overlap_depth())
    total = bucketed_message_bytes(
        cfg, plan, n_data=layout.n_data if layout is not None else None)
    bufs = tuple(upd for upd, _ in outs)
    ret = (bk.unpack(plan, bufs), tuple(mem for _, mem in outs), total)
    return ret + (bufs,) if return_bufs else ret


def _rank() -> int:
    """This worker's global rank (0 without torch.distributed)."""
    return torch.distributed.get_rank() if distributed() else 0


def _noise_of(quant_noise, bucket: int, level: int, index: int):
    """A stage's ``uniforms_of(shape, device)``: ``quant_noise``'s draws
    for (bucket, level, index); None without quantization."""
    if quant_noise is None:
        return None
    return lambda shape, device: quant_noise.uniforms(
        bucket, level, index, tuple(shape), device)


def repack_transport(wspec: enc.WireSpec, buf: torch.Tensor, link=None,
                     live_n: Optional[int] = None):
    """The transport half of the header-aware repack: compact a k-padded
    wire buffer to its live payload (``encoding.repack``; its live count
    from ``live_n`` or the buffer's header), ship exactly that many bytes
    and re-expand it to the padded layout (``encoding.repad``, bit for bit
    the buffer that went in, so the transport is invisible downstream).

    Returns ``(padded_buf_or_future, wire_nbytes)``, the bytes the
    compacted message ships. With ``link=None`` the round trip runs
    inline; with a ``pipeline.EmulatedLink``-style link the small buffer
    rides ``link.transfer(small_buf, wire_nbytes)`` and the returned
    future repads on ``.result()``: in a ``run_host_pipeline`` comm stage
    the planner overlaps the live-k-sized transfer like any gather."""
    small_spec, small_buf = enc.repack(wspec, buf, live_n)
    nbytes = small_spec.nbytes
    if link is None:
        return enc.repad(wspec, small_spec, small_buf), nbytes
    fut = link.transfer(small_buf, nbytes)
    return pipeline.Pending(
        [], lambda: enc.repad(wspec, small_spec, fut.result())), nbytes


def _sparse_leaf_bytes(cfg: SyncConfig, rows: int, cols: int,
                       pod_k: Optional[int] = None) -> int:
    """Exact per-worker bytes one sparse leaf or bucket puts on the wire
    per gather stage: the packed buffer or the (value_dtype, int32) pair
    arrays, at k_row and, for the two-level chain, at the pod k."""
    ks = [cfg.k_for(cols)]
    if cfg.strategy == "hierarchical" and cfg.pod_axis is not None:
        ks.append(pod_k if pod_k is not None else cfg.pod_k_for(cols))
    return sum(_nbytes(cfg, rows, cols, k) for k in ks)


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
            lvl1, lvl2 = (_nbytes(cfg, spec.rows, spec.cols, k)
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


def amortized_bytes_per_step(cfg: SyncConfig, plan: bk.BucketPlan, *,
                             by_level: bool = False,
                             n_data: Optional[int] = None,
                             pod_ks: Optional[Sequence[int]] = None):
    """Bytes per OPTIMIZER step under Qsparse-local-SGD: with
    ``cfg.local_steps`` = H the workers communicate once every H steps, so
    a step costs ``bucketed_message_bytes / H``. Its ``by_level``
    contract; the values are floats."""
    b = bucketed_message_bytes(cfg, plan, by_level=by_level, n_data=n_data,
                               pod_ks=pod_ks)
    H = max(1, cfg.local_steps)
    if isinstance(b, dict):
        return {k: v / H for k, v in b.items()}
    return b / H


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
