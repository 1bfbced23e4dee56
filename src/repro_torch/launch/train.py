"""Train step, loop and CLI for PARALLEL-MEM-SGD (port of
``repro.launch.train`` for the per-leaf and the bucketed paths).

Data-parallel workers are processes of one ``torch.distributed`` group
(``torchrun``; NCCL on the card, gloo on the CPU), one device each: each
holds the full params, its own memory and its slice of the global batch
(``repro_torch.data.ShardedBatcher``), and the sync gathers the workers'
pairs. Without a group the CLI runs one worker.

``make_train_step`` builds the step

    (params, memory, opt, count, batch) -> (params, memory, opt, count, metrics)

Each step computes the gradient with autograd, runs the sync and
subtracts the synced update from the parameters:

  * per-leaf (``sync.bucketed=False``, the train CLI's default):
    ``repro_torch.core.distributed.sparse_sync_gradients`` forms
    u = m + eta*g per leaf, selects the per-row top-k along the leaf's
    column axis (``repro_torch.launch.sharding.sync_col_axes``) with one
    top-k kernel launch per sparse leaf, and keeps u - own as the memory,
    a param-shaped float32 tree;
  * bucketed (``sync.bucketed=True``): ``bucketed_sync_gradients``, one
    fused CUDA kernel launch per sparse bucket forms u, selects and leaves
    the residual as the new memory, one (rows, cols) buffer per bucket.

On a (pod, data) ``launch.mesh.Layout`` (``--pods``, ``--mesh``) the
step's sync takes the layout, and with ``strategy="hierarchical"`` runs
the two-level pod sync: ``train()`` then calibrates per-bucket pod ratios
on the first batch (``PodRatioCalibrator``, ``tc.pod_autotune``) and, with
``tc.pod_refresh``, re-calibrates the live pod ks every few steps from the
live memory and gradients, feeding them to the same step as host ints
(``SyncConfig.pod_dynamic``: every shape stays at its static k_max); a
``pod_k_schedule`` replays a recorded schedule instead.

As the reference donates its step inputs, the port updates ``params`` IN
PLACE and returns them; the old memory is replaced by the sync's output.
``count`` is a host integer, so the eta schedule never waits on the
device. The step's loss is the mean over the workers (the reference's
``_mean_metrics``).

Optimizer modes:
  * ``memsgd``       — paper Algorithm 1/2: update = comp_k(m + eta*g),
    params -= update. eta consumed at memory insertion.
  * ``memsgd_momentum`` — beyond-paper: heavy-ball momentum (``momentum``)
    applied to the synced sparse update: v = momentum*v + update,
    params -= v.
  * ``adam_compressed`` — beyond-paper: the sync (with eta = 1) produces
    the averaged sparse gradient, so the memory accumulates raw
    gradients; Adam (b1 0.9, b2 0.999, eps 1e-8) consumes it at the
    schedule's eta.
  * ``dense``        — uncompressed baseline (the sync's dense strategy).
The optimizer state ``opt`` is () for ``memsgd`` and ``dense``, a
param-shaped float32 tree (the velocity) for ``memsgd_momentum`` and
{"mu", "nu"} of such trees for ``adam_compressed``; like the params, it
is updated in place.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import PodRefreshConfig
from repro_torch.core import buckets as bk
from repro_torch.core.distributed import (
    PodConfig,
    SyncConfig,
    TransportConfig,
    WireConfig,
    _all_gather,
    _densify_mean,
    _exchange,
    _mean,
    amortized_bytes_per_step,
    autotune_pod_ratios,
    bucketed_message_bytes,
    bucketed_sync_gradients,
    distributed,
    message_bytes,
    sparse_sync_gradients,
    world_size,
)
from repro_torch.data.pipeline import take
from repro_torch.kernels import row_topk
from repro_torch.kernels.ref import eta32
from repro_torch.launch.mesh import pod_axis_of
from repro_torch.launch.sharding import sync_col_axes
from repro_torch.optim.adam import bias_correction
from repro_torch.optim.qsgd import QuantNoise
from repro_torch.utils.platform import resolve_device
from repro_torch.utils.telemetry import NonFiniteLossError, Telemetry
from repro_torch.utils.tree import tree_flatten, tree_map

OPTIMIZERS = ("memsgd", "memsgd_momentum", "adam_compressed", "dense")
# adam_compressed's moments and bias corrections (the reference's)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "memsgd"  # memsgd | memsgd_momentum | adam_compressed | dense
    eta: float = 0.1  # base stepsize (or peak LR for adam)
    eta_shift: float = 0.0  # a>0 enables eta_t = eta*a/(a + t) decay
    momentum: float = 0.9
    sync: SyncConfig = dataclasses.field(default_factory=SyncConfig)
    # the gradient as the mean of this many chunks of the local batch
    microbatch: int = 1
    # the two-level pod sync: calibrate per-bucket pod ratios on the first
    # batch when sync.pod_ratios is unset, and the live refresh
    pod_autotune: bool = True
    pod_refresh: Optional[PodRefreshConfig] = None
    # the seed of the QSGD rounding noise (WireConfig.quant): each sync
    # draws from QuantNoise(quant_seed, count), so two runs with one seed
    # draw the same noise
    quant_seed: int = 0
    # emit the applied update as packed per-bucket delta messages for
    # serving replicas (launch.delta_stream): needs sync.bucketed and the
    # memsgd or dense optimizer (whose parameter delta IS the synced
    # update); each sync step then returns them after its metrics, a tuple
    # of uint32 wire buffers
    emit_deltas: bool = False
    delta_value_dtype: str = "float32"  # bf16 halves the stream (lossy)


def _eta_schedule(tc: TrainConfig):
    """Host schedule t -> eta_t, rounded in float32 as the reference's
    traced schedule is."""
    if tc.eta_shift > 0:
        a = tc.eta_shift
        return lambda t: float(
            np.float32(tc.eta * a) / (np.float32(a) + np.float32(t)))
    eta = eta32(tc.eta)
    return lambda t: eta


def _sync_config(tc: TrainConfig, layout=None) -> SyncConfig:
    """The step's sync config: the dense strategy for the dense optimizer,
    and the pod axis of the layout when one is given (the reference's
    from its mesh)."""
    if tc.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {tc.optimizer!r}; options: "
                         f"{OPTIMIZERS}")
    strategy = "dense" if tc.optimizer == "dense" else tc.sync.strategy
    pod_axis = (pod_axis_of(layout) if layout is not None
                else tc.sync.pod_axis)
    return dataclasses.replace(tc.sync.with_pod(axis=pod_axis),
                               strategy=strategy)


def _bucket_plan(sync: SyncConfig, pshapes):
    """The bucket plan of the bucketed path; None on the per-leaf path."""
    if not sync.bucketed:
        return None
    return bk.make_plan(pshapes, cols=sync.bucket_cols,
                        dense_below=sync.dense_below)


def init_train_state(model, tc: TrainConfig, *, device="cuda", seed: int = 0,
                     params=None, layout=None):
    """Returns (params, memory, opt, count): the port's seeded init on
    ``device`` (or the given ``params``), zero float32 memory, the
    optimizer mode's zero state (see the module docstring), count 0. The
    memory is this worker's: a param-shaped tree on the per-leaf path and
    one (rows, cols) buffer per bucket on the bucketed path (the
    reference's carry a leading worker axis; in the port each worker's
    process holds its own)."""
    device = resolve_device(device)
    sync = _sync_config(tc, layout)
    plan = _bucket_plan(sync, model.param_shapes())
    sync.validate(plan)
    if params is None:
        params = model.init(seed=seed, device=device)
    if plan is not None:
        memory = bk.init_bucket_memory(plan, device=device)
    else:
        memory = _f32_zeros(params)
    return params, memory, init_opt_state(tc, params), 0


def _f32_zeros(params):
    return tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)


def init_opt_state(tc: TrainConfig, params):
    """The optimizer mode's zero state on the params' devices."""
    if tc.optimizer == "memsgd_momentum":
        return _f32_zeros(params)
    if tc.optimizer == "adam_compressed":
        return {"mu": _f32_zeros(params), "nu": _f32_zeros(params)}
    return ()


def make_apply_optimizer(tc: TrainConfig, eta_fn):
    """(leaves, opt, count, update leaves) -> opt: subtracts the synced
    update from the params through the optimizer mode, the params and
    the state in place; each op rounds as the reference's
    ``apply_optimizer`` does (two products and a sum, not a fused
    multiply-add)."""
    if tc.optimizer in ("memsgd", "dense"):
        def apply(leaves, opt, count, updates):
            for p, u in zip(leaves, updates):
                p.sub_(u.to(p.dtype))
            return opt
    elif tc.optimizer == "memsgd_momentum":
        def apply(leaves, opt, count, updates):
            for p, v, u in zip(leaves, tree_flatten(opt)[0], updates):
                v.mul_(tc.momentum).add_(u.to(torch.float32))
                p.sub_(v)
            return opt
    else:  # adam_compressed
        b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS

        def apply(leaves, opt, count, updates):
            bc1 = bias_correction(b1, count + 1)
            bc2 = bias_correction(b2, count + 1)
            lr = eta_fn(count)
            mus, nus = tree_flatten(opt["mu"])[0], tree_flatten(opt["nu"])[0]
            for p, mu, nu, u in zip(leaves, mus, nus, updates):
                u = u.to(torch.float32)
                mu.mul_(b1).add_(u * (1 - b1))
                nu.mul_(b2).add_(torch.square(u).mul_(1 - b2))
                step = (mu / bc1).mul_(lr)
                step.div_(torch.sqrt(nu / bc2).add_(eps))
                p.sub_(step)
            return opt
    return apply


def _mean_metrics(metrics):
    """The step's loss and aux loss, means over the workers (device
    tensors: the all-reduce is issued, not waited for)."""
    out = {"loss": metrics["xent"].detach(), "aux": metrics["aux"].detach()}
    if distributed():
        vals = torch.stack([out["loss"], out["aux"]]).float()
        torch.distributed.all_reduce(vals)
        vals /= world_size()
        out = {"loss": vals[0], "aux": vals[1]}
    return out


def _grads(model, params, batch, microbatch: int = 1):
    """(gradient leaves, metrics) of the model's loss on ``batch``, by
    autograd through detached copies of the parameter leaves. With
    ``microbatch`` M > 1 the batch splits into M chunks along its first
    axis and the gradient is their float32 mean, each chunk's added as
    ``c + g / M`` in chunk order (the reference's scan), the metrics
    the chunks' means."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    if microbatch <= 1:
        loss, metrics = model.loss(treedef.unflatten(live), batch)
        return torch.autograd.grad(loss, live), metrics
    M = microbatch
    B = next(iter(batch.values())).shape[0]
    if B % M:
        raise ValueError(f"a batch of {B} does not split into microbatch={M} "
                         "chunks")
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    mets = []
    for c in range(M):
        chunk = {k: v[c * (B // M):(c + 1) * (B // M)]
                 for k, v in batch.items()}
        loss, met = model.loss(treedef.unflatten(live), chunk)
        for a, g in zip(acc, torch.autograd.grad(loss, live)):
            a.add_(torch.div(g.to(torch.float32), M))
        mets.append(met)
    return acc, {k: torch.stack([torch.as_tensor(m[k]).detach().to(
        torch.float32) for m in mets]).mean(0) for k in mets[0]}


def make_train_step(model, tc: TrainConfig, layout=None):
    """Builds the train step (see the module docstring). It runs on the
    device its inputs lie on; ``step.sync``, ``step.plan`` (None on the
    per-leaf path) and ``step.col_axes`` are the validated sync config,
    the bucket plan and the per-leaf column axes it runs with; ``layout``
    the (pod, data) ``launch.mesh.Layout`` its sync gathers over (None:
    the flat default group).

    With ``sync.pod_dynamic`` the step takes a sixth argument, ``pod_ks``:
    one live pod k per bucket (host ints). ``step.pod_k_max`` holds each
    bucket's static padded ceiling.

    With ``sync.local_steps`` = H > 1 (Qsparse-local-SGD, bucketed only)
    the state gains the bucket-space accumulator ``acc``
    (``buckets.init_local_accum``) after the memory,

        (params, memory, acc, opt, count, batch) -> (... the same ...)

    and ``step.accum`` is the local step: ``acc += eta_t * pack(g_t)``
    (``buckets.accumulate_local``), no gradient exchange, params, memory
    and opt untouched. The returned ``step`` is the sync step: it folds
    its own gradient into acc the same way, syncs u = m + acc through
    ``bucketed_sync_gradients(grad_bufs=acc)`` at eta 1.0 and zeroes acc
    in place. Call ``step.accum`` H - 1 times, then ``step``
    (``step.local_steps`` is H). At H = 1 the per-step path is unchanged.
    Under ``sync.quant`` each sync draws its rounding noise from
    ``QuantNoise(tc.quant_seed, count)``.

    With ``tc.emit_deltas`` every sync step returns one more item after
    its metrics: the applied update as packed wire buffers, one per
    bucket (``launch.delta_stream.encode_delta_bufs`` of the sync's update
    buffers), laid out by ``step.delta_spec``; the local steps of
    ``step.accum`` emit none."""
    sync = _sync_config(tc, layout)
    pshapes = model.param_shapes()
    plan = _bucket_plan(sync, pshapes)
    sync.validate(plan)
    if sync.strategy == "hierarchical" and sync.pod_axis and layout is None:
        raise ValueError("the two-level sync (a pod_axis) needs a (pod, "
                         "data) layout: pass layout=")
    H = sync.local_steps
    if H > 1 and plan is None:
        raise ValueError(
            "sync.local_steps > 1 requires sync.bucketed (the local "
            "accumulator lives in bucket space)")
    col_axes = sync_col_axes(pshapes)
    dspec = None
    if tc.emit_deltas:
        if plan is None or tc.optimizer not in ("memsgd", "dense"):
            raise ValueError(
                "emit_deltas requires sync.bucketed and a plain memsgd/dense "
                "optimizer (the parameter delta must equal the synced "
                "update)")
        from repro_torch.launch import delta_stream as ds

        dspec = ds.make_delta_spec(
            plan, sync,
            workers=layout.world if layout is not None else world_size(),
            n_pods=layout.n_pods if layout is not None else 1,
            value_dtype=tc.delta_value_dtype)
    pod_k_max = None
    if sync.pod_dynamic:
        pod_k_max = tuple(
            sync.pod_k_max_for_bucket(b, s.cols, layout.n_data)
            if s.kind == "sparse" else 1 for b, s in enumerate(plan.buckets))
    eta_fn = _eta_schedule(tc)
    # adam_compressed: the memory accumulates raw gradients
    sync_eta = ((lambda t: 1.0) if tc.optimizer == "adam_compressed"
                else eta_fn)
    apply_optimizer = make_apply_optimizer(tc, eta_fn)

    def noise(count):
        return (QuantNoise(tc.quant_seed, count) if sync.quant is not None
                else None)

    def emit(out, up_bufs):
        """The step's outputs, with its delta when it emits one."""
        if dspec is None:
            return out
        return out + (tuple(ds.encode_delta_bufs(dspec, up_bufs)),)

    def step(params, memory, opt, count, batch, pod_ks=None):
        leaves, treedef = tree_flatten(params)
        grads, metrics = _grads(model, params, batch, tc.microbatch)
        up_bufs = None
        if plan is not None:
            update, new_memory, _, up_bufs = bucketed_sync_gradients(
                sync, plan, memory, treedef.unflatten(grads), sync_eta(count),
                layout=layout, pod_ks=pod_ks, quant_noise=noise(count),
                return_bufs=True)
        else:
            update, new_memory, _ = sparse_sync_gradients(
                sync, memory, treedef.unflatten(grads), sync_eta(count),
                col_axes, layout=layout)
        del grads
        with torch.no_grad():
            opt = apply_optimizer(leaves, opt, count,
                                  treedef.flatten_up_to(update))
        del update
        return emit((params, new_memory, opt, count + 1,
                     _mean_metrics(metrics)), up_bufs)

    def accum(params, memory, acc, opt, count, batch):
        treedef = tree_flatten(params)[1]
        grads, metrics = _grads(model, params, batch, tc.microbatch)
        acc = bk.accumulate_local(plan, acc, treedef.unflatten(grads),
                                  sync_eta(count))
        return params, memory, acc, opt, count + 1, _mean_metrics(metrics)

    def sync_step(params, memory, acc, opt, count, batch, pod_ks=None):
        leaves, treedef = tree_flatten(params)
        params, memory, acc, opt, _, metrics = accum(params, memory, acc,
                                                     opt, count, batch)
        update, new_memory, _, up_bufs = bucketed_sync_gradients(
            sync, plan, memory, None, 1.0, layout=layout, pod_ks=pod_ks,
            grad_bufs=acc, quant_noise=noise(count), return_bufs=True)
        for a in acc:
            a.zero_()
        with torch.no_grad():
            opt = apply_optimizer(leaves, opt, count,
                                  treedef.flatten_up_to(update))
        del update
        return emit((params, new_memory, acc, opt, count + 1, metrics),
                    up_bufs)

    if H > 1:
        step = sync_step
        step.accum = accum
    step.sync, step.plan, step.col_axes = sync, plan, col_axes
    step.layout, step.pod_k_max, step.local_steps = layout, pod_k_max, H
    if dspec is not None:
        step.delta_spec = dspec  # the wire layout replicas decode against
    return step


def _rank() -> int:
    return torch.distributed.get_rank() if distributed() else 0


class PodRatioCalibrator:
    """Mass-capture calibration of the two-level pod sync's per-bucket pod
    ks (the reference's ``PodRatioCalibrator``), measured as the reference
    measures it: the global batch split into ``n_data`` shards, shard i's
    u = m_i + eta*g_i with pod 0's worker i's memory (zero at the first
    calibration), the pod stage simulated (each shard's per-row top-k_row,
    densified, the mean over the shards; ``buckets.simulate_pod_mean``).
    When the global batch does not split into n_data shards, or n_data is
    1, the global batch's u with the mean of every worker's memory is the
    proxy.

    Across ranks: the global batch is gathered from the workers' slices;
    pod 0's rank i forms shard i's u and its per-row top-k_row, one bucket
    at a time, and the sync's own intra-pod stages move the selections:
    the gather over pod 0's data group, then rank 0 densifies them shard
    by shard in rank order (the reference's ``simulate_pod_mean`` order)
    and / n_data. So each of those ranks holds one u at a time, where the
    reference's host stack holds n_data copies, and only the (rows, k_row)
    pairs move. Rank 0 measures the curves and allocates, and broadcasts
    the ratios: every rank gets the same ks."""

    def __init__(self, model, plan, layout, sync: SyncConfig):
        self.model, self.plan, self.layout = model, plan, layout
        self.sync = sync  # k_row and the allocation's target and budget
        # the shards' selections move as float32 pairs at any wire dtype
        # and unquantized: the reference forms its shard measurement in
        # float32
        self._wire = sync.with_wire(value_dtype="float32", quant=None)

    def _u(self, params, batch, eta, memory):
        """Per sparse bucket u = eta * g (+ memory) on ``batch``; None for
        the dense buckets."""
        grads, _ = _grads(self.model, params, batch)
        g = bk.pack(self.plan, tree_flatten(params)[1].unflatten(grads),
                    dtype=torch.float32)
        del grads
        out = []
        for b, spec in enumerate(self.plan.buckets):
            if spec.kind == "dense":
                out.append(None)
                continue
            u = g[b].mul_(eta32(eta))
            out.append(u if memory is None else u.add_(memory[b]))
            g[b] = None
        return out

    def u_bufs(self, params, batch, eta, memory=None):
        """On rank 0 the per-bucket (rows, cols) buffers the allocation
        measures (the simulated pod mean, or the global u), None for the
        dense buckets; None on the other ranks. Every rank must call it."""
        lay = self.layout
        n_data = lay.n_data
        full = {k: _all_gather(v).flatten(0, 1) for k, v in batch.items()}
        B = next(iter(full.values())).shape[0]
        if B % n_data == 0 and n_data > 1:
            if lay.pod != 0:
                return None
            n = B // n_data
            shard = {k: v[lay.data * n:(lay.data + 1) * n]
                     for k, v in full.items()}
            out = []
            for u in self._u(params, shard, eta, memory):
                if u is not None:
                    k_row = self.sync.k_for(u.shape[1])
                    vals, idx = row_topk(u, k_row)
                    gv, gi = _exchange(self._wire, vals, idx, u.shape[1],
                                       lay.data_group)
                    del vals, idx
                    u = (_densify_mean(u.zero_(), 1, gv, gi, k_row, False)
                         if lay.rank == 0 else None)
                    del gv, gi
                out.append(u)
            return out if lay.rank == 0 else None
        mean_m = None
        if memory is not None:
            mean_m = [_mean(m) if spec.kind == "sparse" else None
                      for spec, m in zip(self.plan.buckets, memory)]
        if lay.rank != 0:
            return None
        return self._u(params, full, eta, mean_m)

    def ratios(self, params, batch, eta, memory=None, *, mass_target=None,
               k_caps=None, byte_budget=None) -> tuple:
        """Per-bucket pod ratios (``_calibrate_pod_ratios`` on rank 0's
        buffers), the same on every rank."""
        bufs = self.u_bufs(params, batch, eta, memory)
        out = torch.zeros(len(self.plan.buckets), dtype=torch.float64,
                          device=next(iter(batch.values())).device)
        if bufs is not None:
            out.copy_(torch.tensor(_calibrate_pod_ratios(
                self.sync, self.plan, bufs, self.layout.n_data,
                mass_target=mass_target, k_caps=k_caps,
                byte_budget=byte_budget), dtype=torch.float64))
        del bufs
        torch.distributed.broadcast(out, 0)
        return tuple(out.tolist())


def _calibrate_pod_ratios(sync_cfg, plan, u_bufs, n_data, mass_target=None,
                          k_caps=None, byte_budget=None):
    """Per-bucket pod ratios from measured buffers, in either sizing mode:
    a byte budget (the argument, else ``SyncConfig.byte_budget``)
    water-fills the cross-pod allowance over the buckets
    (``core.budget.BudgetController``); otherwise the mass-target
    autotune sizes each bucket on its own."""
    budget = (byte_budget if byte_budget is not None
              else sync_cfg.byte_budget)
    if budget is not None:
        from repro_torch.core.budget import BudgetController

        ctl = BudgetController(sync_cfg, plan, n_data, k_caps=k_caps)
        return ctl.ratios_of(ctl.allocate(u_bufs, byte_budget=budget))
    return autotune_pod_ratios(sync_cfg, plan, u_bufs, n_data=n_data,
                               mass_target=mass_target, k_caps=k_caps)


def _maybe_autotune_pod_ratios(model, layout, tc: TrainConfig, plan, params,
                               batches, calib=None):
    """The calibration pass of the two-level pod sync: when training
    hierarchical and bucketed on a pod layout with no explicit
    ``sync.pod_ratios``, peek the first batch, measure each bucket's
    realized mass capture (u = eta*g at zero memory) and set per-bucket
    pod ratios before the step is built. Returns ``(tc, batches)`` with
    the peeked batch pushed back."""
    if not (tc.pod_autotune and plan is not None
            and tc.sync.strategy == "hierarchical"
            and pod_axis_of(layout) is not None
            and tc.sync.pod_ratios is None):
        return tc, batches
    first = next(batches, None)
    if first is None:
        return tc, batches
    sync = _sync_config(tc, layout)
    calib = calib or PodRatioCalibrator(model, plan, layout, sync)
    ratios = calib.ratios(params, first, tc.eta)
    tc = dataclasses.replace(tc, sync=tc.sync.with_pod(ratios=ratios))
    lv = bucketed_message_bytes(sync.with_pod(ratios=ratios), plan,
                                by_level=True, n_data=layout.n_data)
    if _rank() == 0:
        print("pod autotune: ratios=" + ",".join(f"{r:.4g}" for r in ratios)
              + f"  intra-pod {lv['intra']}B cross-pod {lv['cross']}B "
              "/step/worker")
    return tc, itertools.chain([first], batches)


def _telemetry_bytes(model, step, pod_ks=None) -> dict:
    """Per-step wire accounting for the telemetry sink: ``{"intra",
    "cross", "total"}`` on a pod layout (``pod_ks``: the live ks, as the
    repack transport ships them), else ``{"total"}``; on the bucketed
    path ``amortized_bytes_per_step`` (a step's share of the sync's bytes
    under local steps)."""
    if step.plan is None:
        return {"total": message_bytes(step.sync, model.param_shapes(),
                                       step.col_axes)}
    if pod_axis_of(step.layout) is not None:
        return amortized_bytes_per_step(step.sync, step.plan, by_level=True,
                                        n_data=step.layout.n_data,
                                        pod_ks=pod_ks)
    return {"total": amortized_bytes_per_step(step.sync, step.plan)}


def train(model, tc: TrainConfig, batches, n_steps: int, *, device="cuda",
          seed: int = 0, params=None, log_every: int = 10, telemetry=None,
          layout=None, pod_k_schedule=None, checkpointer=None,
          ckpt_every: int = 0, delta_sink=None, ckpt_wire: bool = False,
          ckpt_memory_ratio: float = 0.05):
    """End-to-end training loop on ``device`` (CUDA unless the caller asks
    for the CPU). ``batches``: iterator of batches already on ``device``
    (see ``repro_torch.data.DeviceBatcher``; this worker's slice under
    ``torch.distributed``). ``layout``: the (pod, data)
    ``launch.mesh.Layout``, or None. Returns (params, memory, opt, count,
    history) with history the logged (step, loss) pairs.

    ``telemetry`` — a ``repro_torch.utils.telemetry.Telemetry`` sink fed
    every step's loss and bytes; when omitted an internal sink runs, so a
    NaN/inf loss raises ``NonFiniteLossError`` (carrying the partial
    ``history``) instead of training on garbage. Each step's device loss
    is read only after the NEXT step has been issued, so the host's read
    never waits on the step it just issued.

    The two-level pod sync: with ``tc.pod_refresh`` enabled, the
    per-bucket pod ks re-calibrate every ``pod_refresh.every`` steps from
    the live memory and gradient buffers and go to the same step as host
    ints (clamped to its static ``pod_k_max``), each recorded in the
    telemetry's ``refresh_schedule``. ``pod_k_schedule``, a sequence of
    ``(step, ks)``,
    REPLAYS a recorded schedule instead of calibrating: a run fed the
    refreshed run's ``telemetry.refresh_schedule`` reproduces it bit for
    bit.

    With ``tc.emit_deltas``, ``delta_sink(step_index, wire_msgs)`` is
    called with each sync step's packed delta buffers (decode them against
    ``make_train_step(...).delta_spec``; ``launch.delta_stream``).
    ``checkpointer`` (a ``repro_torch.checkpoint.Checkpointer``) saves
    every ``ckpt_every`` steps: ``{"params": params}`` densely, or with
    ``ckpt_wire`` (needs ``sync.bucketed``) through the packed codec
    (``Checkpointer.save_wire``): the params diff-encoded against the boot
    params, the memory capped at ``ckpt_memory_ratio`` a row.

    Qsparse-local-SGD (``sync.local_steps`` = H > 1): step i syncs when
    (i + 1) % H == 0 (round j = i // H) and only accumulates otherwise
    (``step.accum``); a pod refresh runs on sync steps, at rounds j > 0
    with j % ``pod_refresh.every`` == 0, calibrating on m + acc (what the
    sync compresses); the telemetry's bytes are a step's share of the
    sync's (``amortized_bytes_per_step``)."""
    device = resolve_device(device)
    if ckpt_wire and not tc.sync.bucketed:
        raise ValueError("ckpt_wire requires sync.bucketed (a BucketPlan)")
    refresh = tc.pod_refresh if (
        tc.pod_refresh is not None and tc.pod_refresh.enabled) else None
    if refresh is not None or pod_k_schedule is not None:
        kw = {"dynamic": True}
        if refresh is not None and refresh.k_max_ratio is not None:
            kw["k_max_ratio"] = refresh.k_max_ratio
        tc = dataclasses.replace(tc, sync=tc.sync.with_pod(**kw))
    plan = _bucket_plan(tc.sync, model.param_shapes())
    dyn = tc.sync.pod_dynamic
    if dyn and (plan is None or tc.sync.strategy != "hierarchical"
                or pod_axis_of(layout) is None):
        raise ValueError(
            "pod_refresh / pod_k_schedule / sync.pod_dynamic require "
            "sync.bucketed, strategy='hierarchical' and a (pod, data) layout")
    params, memory, opt, count = init_train_state(
        model, tc, device=device, seed=seed, params=params, layout=layout)
    batches = iter(batches)
    calib = (PodRatioCalibrator(model, plan, layout,
                                _sync_config(tc, layout)) if dyn else None)
    tc, batches = _maybe_autotune_pod_ratios(model, layout, tc, plan, params,
                                             batches, calib=calib)
    base_params = None
    if ckpt_wire and checkpointer is not None:
        from repro_torch.launch.serve import replica_copy

        base_params = replica_copy(params)  # the step updates params in place
    step = make_train_step(model, tc, layout)
    H = step.local_steps
    acc = bk.init_local_accum(plan, device=device) if H > 1 else None
    eta_fn = _eta_schedule(tc)
    tel_owned = telemetry is None
    tel = telemetry if telemetry is not None else Telemetry()
    live_ks = None
    sched = dict(pod_k_schedule) if pod_k_schedule is not None else None
    if dyn:
        live_ks = tuple(
            step.sync.pod_k_for_bucket(b, s.cols) if s.kind == "sparse" else 1
            for b, s in enumerate(plan.buckets))
    tel.initial_pod_ks = live_ks
    bytes_live = _telemetry_bytes(model, step, live_ks)
    tel.set_bytes_per_step(bytes_live)
    history = []

    # one-step-late loss readback: float(loss) blocks until the step that
    # produced it has run, so it is drained only after the next step is
    # issued (detection and printing lag one step); the byte accounting
    # in effect at issue rides along
    pending = None

    def _drain(rec):
        idx, dev_loss, log_rec, bytes_rec = rec
        loss = float(dev_loss)
        tel.set_bytes_per_step(bytes_rec)
        try:
            tel.step(idx, loss, log=log_rec)
        except NonFiniteLossError as e:
            e.history = list(history)
            if tel_owned:
                tel.close()
            raise
        if log_rec:
            history.append((idx, loss))

    for i, batch in enumerate(take(batches, n_steps)):
        j, is_sync = i // H, (i + 1) % H == 0
        if dyn and sched is not None and i in sched:
            # clamped here, so that the recorded schedule and the bytes
            # describe the ks the wire carries
            live_ks = tuple(max(1, min(int(k), int(c)))
                            for k, c in zip(sched[i], step.pod_k_max))
            tel.pod_refresh(i, live_ks)
            bytes_live = _telemetry_bytes(model, step, live_ks)
        elif (dyn and sched is None and refresh is not None and is_sync
              and j > 0 and j % refresh.every == 0):
            # at the eta the step applies (adam_compressed's memory takes
            # raw gradients: 1.0), on the state before step i; at H > 1
            # the sync compresses m + acc (+ eta*g)
            eta_now = (eta_fn(i) if tc.optimizer != "adam_compressed"
                       else 1.0)
            ratios = calib.ratios(
                params, batch, eta_now, memory if acc is None else
                [torch.add(m, a) for m, a in zip(memory, acc)],
                mass_target=refresh.mass_target, k_caps=step.pod_k_max,
                byte_budget=refresh.byte_budget)
            live_ks = tuple(int(round(r * s.cols)) if s.kind == "sparse"
                            else 1 for r, s in zip(ratios, plan.buckets))
            bytes_live = _telemetry_bytes(model, step, live_ks)
            cross = bucketed_message_bytes(
                step.sync, plan, by_level=True, n_data=layout.n_data,
                pod_ks=live_ks)["cross"]
            if _rank() == 0:
                print(f"pod refresh @ step {i}: ks="
                      + ",".join(str(k) for k in live_ks)
                      + f"  effective cross-pod {cross}B /step/worker")
            tel.pod_refresh(i, live_ks, cross_bytes=cross)
        args = (live_ks,) if dyn else ()
        if H == 1:
            out = step(params, memory, opt, count, batch, *args)
            params, memory, opt, count, metrics = out[:5]
        elif is_sync:
            out = step(params, memory, acc, opt, count, batch, *args)
            params, memory, acc, opt, count, metrics = out[:6]
        else:
            out = step.accum(params, memory, acc, opt, count, batch)
            params, memory, acc, opt, count, metrics = out
        if tc.emit_deltas and is_sync and delta_sink is not None:
            delta_sink(i, out[-1])
        del out
        do_log = bool(log_every and (i % log_every == 0 or i == n_steps - 1))
        if pending is not None:
            _drain(pending)
        pending = (i, metrics["loss"], do_log, bytes_live)
        if tel.should_stop:
            print(f"telemetry early stop @ step {i}: {tel.stop_reason}")
            break
        if checkpointer is not None and ckpt_every and (
                (i + 1) % ckpt_every == 0):
            if ckpt_wire:
                checkpointer.save_wire(
                    i + 1, params, memory, step.plan, base_params=base_params,
                    memory_ratio=ckpt_memory_ratio)
            else:
                checkpointer.save(i + 1, {"params": params})
    if pending is not None:
        _drain(pending)  # the last issued step's loss
    if tel_owned:
        tel.close()
    return params, memory, opt, count, history


# the CLI's sync flags that a preset takes as overrides: flag -> field
_OVERRIDES = (("ratio", "ratio"), ("strategy", "strategy"),
              ("local_steps", "local_steps"), ("wire", "wire"),
              ("wire_quant", "quant"), ("pod_ratio", "pod_ratio"),
              ("pod_mass_target", "pod_mass_target"),
              ("pod_k_max_ratio", "pod_k_max_ratio"),
              ("byte_budget", "byte_budget"), ("repack", "repack"),
              ("overlap", "overlap"))
# --overlap's values: SyncConfig.overlap
_OVERLAP = {"auto": None, "on": True, "off": False}


def _sync_from_args(ap, args) -> SyncConfig:
    """The sync config of the CLI. With ``--preset`` the named
    ``SyncConfig.preset`` bundle is the base and only flags given
    explicitly (other than their default) override it, as the reference's
    ``_sync_from_args`` does; without one, every flag lands in the
    grouped configs. ``--emit-deltas``, ``--ckpt-wire``,
    ``--pod-refresh-every``, ``--local-steps`` above 1 and ``--wire-quant``
    imply the bucketed path."""
    bucketed = (args.bucketed or args.emit_deltas or args.ckpt_wire
                or args.pod_refresh_every > 0 or args.local_steps > 1
                or args.wire_quant is not None)
    fields = {field: getattr(args, flag) for flag, field in _OVERRIDES}
    fields["overlap"] = _OVERLAP[args.overlap]
    if args.preset is not None:
        overrides = {field: fields[field] for flag, field in _OVERRIDES
                     if getattr(args, flag) != ap.get_default(flag)}
        if bucketed:
            overrides["bucketed"] = True
        return SyncConfig.preset(args.preset, **overrides)
    return SyncConfig(
        ratio=args.ratio, strategy=args.strategy,
        local_steps=args.local_steps, bucketed=bucketed,
        wire=WireConfig(wire=args.wire, quant=args.wire_quant),
        pod=PodConfig(ratio=args.pod_ratio,
                      mass_target=args.pod_mass_target,
                      k_max_ratio=args.pod_k_max_ratio),
        transport=TransportConfig(repack=args.repack,
                                  byte_budget=args.byte_budget,
                                  overlap=fields["overlap"]))


def _join_workers(platform: str) -> bool:
    """Under ``torchrun`` with WORLD_SIZE > 1, joins the workers' process
    group (NCCL on the card, gloo on the CPU; address, rank and size from
    torchrun's environment) unless one is initialised already. Returns
    whether it made the group."""
    if distributed() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    torch.distributed.init_process_group(
        "nccl" if platform == "cuda" else "gloo")
    return True


def _layout_from_args(args):
    """The worker layout of ``--mesh`` or ``--pods`` (None: the flat
    default group); a layout the workers do not fill raises."""
    from repro_torch.configs import MESHES
    from repro_torch.launch.mesh import make_layout, mesh_from_config

    if args.mesh:
        return mesh_from_config(MESHES[args.mesh])
    if args.pods > 1:
        return make_layout(args.pods)
    return None


def main(argv=None):
    """CLI: train an architecture's SMOKE variant end to end.

        python -m repro_torch.launch.train [--preset topk] [--bucketed]
            [--wire packed] [--platform cpu]
        torchrun --nproc_per_node 2 -m repro_torch.launch.train \
            --platform cpu --preset qsparse_local --steps 8
        torchrun --nproc_per_node 2 -m repro_torch.launch.train \
            --platform cpu --preset topk --ratio 0.02
        torchrun --nproc_per_node 4 -m repro_torch.launch.train \
            --platform cpu --pods 2 --strategy hierarchical --bucketed \
            --wire packed --pod-refresh-every 2 [--overlap on]
        python -m repro_torch.launch.train --platform cpu --emit-deltas \
            --ckpt-wire --ckpt-dir DIR

    Each worker trains on its slice of the global ``--batch``; only rank
    0 prints. With ``--ckpt-dir`` rank 0 checkpoints every ``--steps //
    2`` steps, and ``--ckpt-wire`` prints the last wire checkpoint's size;
    ``--emit-deltas`` prints the delta stream's bytes.
    """
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ARCH_IDS, MESHES, get_smoke_config
    from repro_torch.data import ShardedBatcher, token_batches
    from repro_torch.models import build_model

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--optimizer", default="memsgd",
                    help=f"one of {OPTIMIZERS}")
    ap.add_argument("--eta", type=float, default=0.5)
    ap.add_argument("--ratio", type=float, default=0.01)
    ap.add_argument("--strategy", default="sparse_allgather")
    ap.add_argument("--mesh", default=None, choices=sorted(MESHES),
                    help="named worker layout (repro_torch.configs.MESHES); "
                         "its workers must be the run's")
    ap.add_argument("--pods", type=int, default=1,
                    help="split the workers into this many pods (a (pod, "
                         "data) layout: the hierarchical strategy "
                         "re-compresses at the pod boundary)")
    ap.add_argument("--pod-ratio", type=float, default=None,
                    help="global pod re-compression ratio (hierarchical); "
                         "autotuned per bucket by default")
    ap.add_argument("--pod-mass-target", type=float, default=0.9,
                    help="mass-capture target of the per-bucket pod-ratio "
                         "autotune")
    ap.add_argument("--no-pod-autotune", action="store_true",
                    help="no per-bucket pod-ratio calibration")
    ap.add_argument("--pod-refresh-every", type=int, default=0,
                    help="re-calibrate the per-bucket pod ks every N steps "
                         "from the live memory and gradients (the k-padded "
                         "runtime pod k; needs --strategy hierarchical on a "
                         "pod layout, implies --bucketed; 0: off)")
    ap.add_argument("--pod-k-max-ratio", type=float, default=None,
                    help="cap the static padded pod k at this fraction of "
                         "the bucket's cols (default: the n_data * k_row "
                         "support bound)")
    ap.add_argument("--byte-budget", type=int, default=None,
                    help="cross-pod bytes per step per worker: the pod ks "
                         "water-fill it over the buckets by marginal mass "
                         "per byte (repro_torch.core.budget) instead of "
                         "the mass-capture target")
    ap.add_argument("--repack", action="store_true",
                    help="the header-aware repack boundary before the "
                         "cross-pod gather (the identity inside a step; "
                         "the cross-pod bytes are accounted at the live "
                         "pod k)")
    ap.add_argument("--bucketed", action="store_true",
                    help="flat-buffer bucketed sync (repro_torch.core."
                         "buckets); without it, the per-leaf sync")
    ap.add_argument("--preset", default=None,
                    choices=("dense", "topk", "qsparse_local",
                             "pod_budgeted"),
                    help="start from a named SyncConfig.preset; other "
                         "sync flags given EXPLICITLY override its fields")
    ap.add_argument("--local-steps", type=int, default=1,
                    help="Qsparse-local-SGD: H uncommunicated local steps "
                         "(eta_t * g_t accumulated in bucket space beside "
                         "the memory), then ONE sync through top-k (and "
                         "--wire-quant): bytes per step fall by H (implies "
                         "--bucketed; 1: the per-step sync)")
    ap.add_argument("--wire-quant", type=int, default=None,
                    help="QSGD stochastic quantization to s levels of the "
                         "sparse wire's values: one f32 row norm and "
                         "(1 + ceil(log2(s+1)))-bit codes a value on the "
                         "packed wire; the memory keeps the quantization "
                         "error (implies --bucketed)")
    ap.add_argument("--quant-seed", type=int, default=0,
                    help="seed of the QSGD rounding noise (the step count "
                         "is mixed in every step)")
    ap.add_argument("--wire", default="unpacked",
                    choices=("unpacked", "packed"),
                    help="sync wire format (repro_torch.core.encoding)")
    ap.add_argument("--overlap", default="auto", choices=tuple(_OVERLAP),
                    help="the bucket pipeline's schedule "
                         "(repro_torch.core.pipeline): 'on' double-buffers, "
                         "bucket b's all-gather in flight while bucket b+1 "
                         "selects and encodes; 'off' pins the strict "
                         "sequential schedule; 'auto' keeps the plain "
                         "bucket-after-bucket emission. Params and memory "
                         "are bitwise identical in all modes")
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch, split over the workers")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="device to train on; 'cpu' runs every kernel's "
                         "plain version")
    ap.add_argument("--emit-deltas", action="store_true",
                    help="stream packed parameter deltas for serving "
                         "replicas (launch.delta_stream; implies "
                         "--bucketed)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint into this directory every steps // 2 "
                         "steps")
    ap.add_argument("--ckpt-wire", action="store_true",
                    help="checkpoint params and memory through the packed "
                         "wire codec instead of dense float32 dumps "
                         "(implies --bucketed)")
    ap.add_argument("--ckpt-memory-ratio", type=float, default=0.05,
                    help="per-row top-k ratio of the wire checkpoint's "
                         "lossy memory section")
    args = ap.parse_args(argv)

    sync = _sync_from_args(ap, args)
    device = resolve_device(args.platform)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    made = _join_workers(args.platform)
    try:
        rank = _rank()
        layout = _layout_from_args(args)
        cfg = get_smoke_config(args.arch)
        model = build_model(cfg)
        refresh = (PodRefreshConfig(every=args.pod_refresh_every,
                                    k_max_ratio=args.pod_k_max_ratio)
                   if args.pod_refresh_every > 0 else None)
        tc = TrainConfig(optimizer=args.optimizer, eta=args.eta, sync=sync,
                         pod_autotune=not args.no_pod_autotune,
                         pod_refresh=refresh, quant_seed=args.quant_seed,
                         emit_deltas=args.emit_deltas)
        batches = ShardedBatcher(
            token_batches(cfg.vocab_size, args.batch, args.seq, seed=0),
            device)
        ck = (Checkpointer(args.ckpt_dir)
              if args.ckpt_dir and rank == 0 else None)
        streamed = [0]

        def sink(i, msgs):
            streamed[0] += sum(m.nbytes for m in msgs)

        tel = Telemetry(printer=print if rank == 0 else lambda line: None)
        with tel:
            out = train(model, tc, batches, n_steps=args.steps,
                        device=device, telemetry=tel, layout=layout,
                        checkpointer=ck, ckpt_every=max(1, args.steps // 2),
                        delta_sink=sink if args.emit_deltas else None,
                        ckpt_wire=args.ckpt_wire,
                        ckpt_memory_ratio=args.ckpt_memory_ratio)
        if args.ckpt_wire and ck is not None:
            with open(ck._wire_path(ck.latest_wire_step()) + ".json") as f:
                w = json.load(f)["wire"]
            print(f"wire checkpoint: {w['nbytes'] / 1e6:.2f} MB (dense f32 "
                  f"dump: {w['dense_nbytes'] / 1e6:.2f} MB, "
                  f"x{w['ratio_vs_dense']:.1f} smaller)")
        if args.emit_deltas and rank == 0:
            dense = model.n_params() * 4 * args.steps
            print(f"delta stream: {streamed[0] / 1e6:.2f} MB over "
                  f"{args.steps} steps (dense refresh would be "
                  f"{dense / 1e6:.2f} MB)")
        return out
    finally:
        if made:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
