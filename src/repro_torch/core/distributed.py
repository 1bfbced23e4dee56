"""PARALLEL-MEM-SGD gradient sync (port of ``repro.core.distributed``):
the bucketed path and the per-leaf path.

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

The wire: ``"unpacked"`` gathers the (value_dtype values, int32 indices)
arrays; ``"packed"`` encodes each worker's pairs into one uint32 buffer
(``core.encoding``), gathers the buffers (their int32 view) and decodes
them. Gathered pairs tile along the last axis in rank order, and the
densify adds them one worker at a time in that order (within a worker a
row's indices are distinct), so packed and unpacked give the same bits and
every rank the same update. Dense leaves and buckets take a mean
all-reduce (the reference's ``pmean``).

Workers: the ``torch.distributed`` group whenever one is initialised (NCCL
on the card, gloo on the CPU; W = 1 included, so the card runs the NCCL
gather), else one worker whose gather is the identity.

What the port runs: the ``sparse_allgather`` and ``dense`` strategies,
both wires, float32 or bf16 wire values, any number of workers, and the
``dense`` and ``topk`` presets. Every other option raises
``NotImplementedError`` naming it: the hierarchical strategy,
quantization, local steps > 1 and the overlap schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import buckets as bk
from repro_torch.core import encoding as enc
from repro_torch.kernels import fused_memsgd_update, row_topk
from repro_torch.kernels.ref import eta32
from repro_torch.utils.tree import tree_flatten

STRATEGIES = ("sparse_allgather", "hierarchical", "dense")
SELECTIONS = ("topk_scatter", "argmax_onehot", "threshold_onehot")
VALUE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """How gradients are synchronized across the data-parallel workers.

    Flat fields with the reference's names and defaults (the reference
    groups the pod/wire/transport knobs into sub-configs). The reference's
    ``layout`` and ``constrain_intermediates`` serve its partitioner and
    have no counterpart: with no model axis (each worker holds whole
    tensors) every layout selects over the same rows."""

    strategy: str = "sparse_allgather"  # | "dense" ("hierarchical" not ported)
    ratio: float = 0.001  # per-row k_row = max(k_min, ratio * row_len)
    k_min: int = 1
    k_max: Optional[int] = None
    local_steps: int = 1  # > 1 (Qsparse-local-SGD) not ported
    dense_below: int = 16_384  # smaller leaves sync densely
    # the reference's selection implementations; every one gives the same
    # contract. The bucketed path runs each on the fused kernel; the
    # per-leaf path maps each to a top-k method (_row_topk_method)
    selection: str = "argmax_onehot"
    argmax_k_limit: int = 64  # argmax_onehot takes the threshold above it
    bucketed: bool = False  # False: the per-leaf path
    bucket_cols: int = 1024
    wire: str = "unpacked"  # | "packed" (core.encoding)
    value_dtype: str = "float32"
    quant: Optional[int] = None  # QSGD levels, not ported
    overlap: Optional[bool] = None  # bucket pipeline schedule, not ported

    @classmethod
    def preset(cls, name: str, **overrides) -> "SyncConfig":
        """A known-good bundle of the reference's (``SyncConfig.preset``),
        with flat ``overrides`` set on top:

        * ``"dense"`` — vanilla data-parallel all-reduce.
        * ``"topk"``  — the paper's Mem-SGD: bucketed top-k over the
          packed wire.
        * ``"qsparse_local"`` and ``"pod_budgeted"`` are not ported (local
          steps with quantization; the hierarchical sync with the repack
          transport) and raise ``NotImplementedError``.
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

    def validate(self) -> "SyncConfig":
        """Raise a named error for an unknown value (``ValueError``) or an
        option the port does not run yet (``NotImplementedError``)."""
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
        unported = [
            (self.strategy == "hierarchical", "strategy='hierarchical'"),
            (self.quant is not None, "quant (QSGD wire quantization)"),
            (self.local_steps > 1, "local_steps > 1"),
            (self.overlap is not None, "overlap (bucket pipeline)"),
        ]
        for hit, name in unported:
            if hit:
                raise NotImplementedError(
                    f"SyncConfig {name} is not ported to the PyTorch port yet")
        return self

    def k_for(self, row_len: int) -> int:
        k = max(self.k_min, int(round(self.ratio * row_len)))
        if self.k_max is not None:
            k = min(k, self.k_max)
        return min(k, row_len)


# the reference's bundles (its _PRESETS), in the port's flat fields
_PRESETS = {
    "dense": dict(strategy="dense"),
    "topk": dict(strategy="sparse_allgather", bucketed=True, wire="packed"),
}
_UNPORTED_PRESETS = {
    "qsparse_local": "local steps with quant, the QSGD wire",
    "pod_budgeted": "the hierarchical strategy with the repack transport",
}


def distributed() -> bool:
    """Whether a torch.distributed group is initialised: the sync then
    gathers through it, whatever its size."""
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def world_size() -> int:
    """Data-parallel workers: the torch.distributed world, else 1."""
    return torch.distributed.get_world_size() if distributed() else 1


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    """(W,) + x.shape: every worker's x in rank order (x itself, with a
    leading axis, without a group)."""
    if not distributed():
        return x.unsqueeze(0)
    out = torch.empty(world_size() * x.numel(), dtype=x.dtype,
                      device=x.device)
    torch.distributed.all_gather_into_tensor(out, x.contiguous().view(-1))
    return out.view((world_size(),) + tuple(x.shape))


def _mean(u: torch.Tensor) -> torch.Tensor:
    """The mean of u over the workers (the reference's ``pmean``): a sum
    all-reduce, then / W."""
    if not distributed():
        return u
    out = u.clone()
    torch.distributed.all_reduce(out)
    return out.div_(world_size()) if world_size() > 1 else out


def _gather_pairs(vals: torch.Tensor, idx: torch.Tensor):
    """(rows, k) pairs -> every worker's, tiled along the last axis in
    rank order: (rows, W*k)."""
    rows, k = vals.shape
    tile = lambda x: x.movedim(0, 1).reshape(rows, -1)  # noqa: E731
    return tile(_all_gather(vals)), tile(_all_gather(idx))


def _gather_buf(buf: torch.Tensor) -> torch.Tensor:
    """Every worker's wire buffer, (W, words) uint32, in rank order (the
    collective moves their int32 view)."""
    return _all_gather(buf.view(torch.int32)).view(torch.uint32)


def _decode_packed(bufs: torch.Tensor, wspec: enc.WireSpec):
    """(W, words) gathered buffers -> pairs (rows, W*k) in the tile order
    of ``_gather_pairs``, so the densify sees the unpacked wire's
    pairs."""
    vals, idx = zip(*(enc.decode(wspec, b) for b in bufs))
    tile = lambda xs: torch.stack(xs, 1).reshape(wspec.rows, -1)  # noqa
    return tile(vals), tile(idx)


def _exchange(cfg: "SyncConfig", vals: torch.Tensor, idx: torch.Tensor,
              cols: int):
    """The wire stages of one sparse bucket or leaf: this worker's (rows,
    k) pairs -> every worker's, (rows, W*k) values in ``value_dtype`` and
    int32 indices. Packed: encode -> gather -> decode; unpacked: gather."""
    value_dtype = getattr(torch, cfg.value_dtype)
    if cfg.wire == "packed":
        rows, k = vals.shape
        wspec = enc.WireSpec(rows, cols, k, cfg.value_dtype)
        return _decode_packed(_gather_buf(enc.encode(wspec, vals, idx)),
                              wspec)
    return _gather_pairs(vals.to(value_dtype), idx)


def _densify_mean(like: torch.Tensor, col_axis: int, gv: torch.Tensor,
                  gi: torch.Tensor, k: int, value_dtype) -> torch.Tensor:
    """The gathered pairs (rows, W*k), scattered along ``col_axis`` of a
    zero tensor of ``like``'s shape in the wire's value dtype, / W, as
    float32: one ``scatter_add_`` per worker, in rank order (a row's
    indices are distinct within one worker, so no two adds race)."""
    out = torch.zeros_like(like, dtype=value_dtype)
    view = out.movedim(col_axis, -1)
    lead = view.shape[:-1]
    W = gv.shape[1] // k
    for w in range(W):
        part = slice(w * k, (w + 1) * k)
        view.scatter_add_(-1, gi[:, part].to(torch.int64).reshape(*lead, k),
                          gv[:, part].reshape(*lead, k))
    if W > 1:
        out.div_(W)
    return out.to(torch.float32)


def _sparse_bytes(cfg: "SyncConfig", rows: int, cols: int) -> int:
    """Bytes one sparse bucket or leaf puts on the wire per worker."""
    return enc.message_nbytes(rows, cols, cfg.k_for(cols), cfg.value_dtype,
                              cfg.wire)


def _row_topk_method(cfg: SyncConfig, k_row: int) -> str:
    """The ``kernels.row_topk`` method for one leaf (the reference's
    ``_pick_selection``, whose rule it keeps): ``argmax_onehot`` is the
    loop up to ``argmax_k_limit`` and the threshold above it,
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
                          col_axes=None):
    """PARALLEL-MEM-SGD gradient exchange on a parameter tree, leaf by leaf.

    ``memory_tree``: this worker's float32 memory, one tensor of each
    leaf's shape. ``eta``: a number. ``col_axes``: tree of ints (None: the
    last axis), the axis each leaf selects along
    (``repro_torch.launch.sharding.sync_col_axes``).

    Per leaf: u = m + eta*g (two float32 ops, eta rounded to float32
    once). A leaf below ``dense_below`` entries, or every leaf under
    ``strategy="dense"``, ships all of u. Any other leaf hands the kernel
    its rows with the column axis last, contiguous (a copy when the axis
    was not last, freed once selected), selects k = ``k_for(C)`` pairs per
    row with ``kernels.row_topk``, sends them over the wire, scatters every
    worker's pairs back through the moved view into a tensor in the
    parameter's own layout as the update (in ``value_dtype``, / W, back to
    float32), and keeps u with its own selected entries zeroed as its
    memory (the reference's u - own, up to the sign of zero there).

    Returns (update_tree [float32, SUBTRACT from params], new_memory_tree,
    bytes_per_worker_per_step). Every returned leaf has the layout of its
    memory and gradient leaves (contiguous when they are), whatever its
    column axis, so the memory's layout does not drift from step to step.
    """
    cfg.validate()
    value_dtype = getattr(torch, cfg.value_dtype)
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
        gv, gi = _exchange(cfg, vals, idx, C)
        ups.append(_densify_mean(u, ca, gv, gi, k_row, value_dtype))
        # memory = u - own: u (this leaf's own tensor) with this worker's
        # selected entries zeroed, as the fused kernel forms it
        moved.scatter_(-1, idx.to(torch.int64).view(*lead, k_row), 0.0)
        mems.append(u)
        total += _sparse_bytes(cfg, u.numel() // C, C)
        del u, moved, vals, idx, gv, gi
    return treedef.unflatten(ups), treedef.unflatten(mems), total


def message_bytes(cfg: SyncConfig, params, col_axes=None) -> int:
    """Per-worker per-step bytes the per-leaf sync puts on the wire for a
    parameter tree (tensors, ``meta`` tensors included): a dense leaf's
    float32 values, a sparse leaf's k = ``k_for(C)`` pairs per row of its
    column axis, as the packed buffer or the unpacked (value_dtype values,
    int32 indices) arrays."""
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
        total += _sparse_bytes(cfg, d // max(C, 1), C)
    return total


def bucketed_sync_gradients(
    cfg: SyncConfig,
    plan: bk.BucketPlan,
    memory_bufs,
    grad_tree,
    eta,
):
    """PARALLEL-MEM-SGD gradient exchange over flat buckets.

    ``memory_bufs``: this worker's float32 (rows, cols) memory, one per
    bucket. ``eta``: a number.

    Returns (update_tree [float32 views into the update buffers, SUBTRACT
    from params], new_memory_bufs, bytes_per_worker_per_step).
    """
    cfg.validate()
    value_dtype = getattr(torch, cfg.value_dtype)
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
            continue
        k_row = cfg.k_for(spec.cols)
        new_m, vals, idx = fused_memsgd_update(m, g, eta, k_row)
        del g
        gv, gi = _exchange(cfg, vals, idx, spec.cols)
        del vals, idx
        ups.append(_densify_mean(new_m, 1, gv, gi, k_row, value_dtype))
        mems.append(new_m)
        del gv, gi
    return bk.unpack(plan, ups), tuple(mems), bucketed_message_bytes(cfg, plan)


def bucketed_message_bytes(cfg: SyncConfig, plan: bk.BucketPlan) -> int:
    """Per-worker per-step bytes the sync puts on the wire for a plan: the
    dense buckets' float32 buffers, and each sparse bucket's pairs, as the
    packed buffer or the unpacked (value_dtype values, int32 indices)
    arrays."""
    cfg.validate()
    total = 0
    for spec in plan.buckets:
        if cfg.strategy == "dense" or spec.kind == "dense":
            total += spec.rows * spec.cols * 4
        else:
            total += _sparse_bytes(cfg, spec.rows, spec.cols)
    return total
