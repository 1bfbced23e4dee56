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
import os

import numpy as np
import torch

from repro_torch.core import buckets as bk
from repro_torch.core.distributed import (
    SyncConfig,
    bucketed_message_bytes,
    bucketed_sync_gradients,
    distributed,
    message_bytes,
    sparse_sync_gradients,
    world_size,
)
from repro_torch.data.pipeline import take
from repro_torch.kernels.ref import eta32
from repro_torch.launch.sharding import sync_col_axes
from repro_torch.optim.adam import bias_correction
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


def _eta_schedule(tc: TrainConfig):
    """Host schedule t -> eta_t, rounded in float32 as the reference's
    traced schedule is."""
    if tc.eta_shift > 0:
        a = tc.eta_shift
        return lambda t: float(
            np.float32(tc.eta * a) / (np.float32(a) + np.float32(t)))
    eta = eta32(tc.eta)
    return lambda t: eta


def _sync_config(tc: TrainConfig) -> SyncConfig:
    if tc.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {tc.optimizer!r}; options: "
                         f"{OPTIMIZERS}")
    strategy = "dense" if tc.optimizer == "dense" else tc.sync.strategy
    return dataclasses.replace(tc.sync, strategy=strategy).validate()


def _bucket_plan(sync: SyncConfig, pshapes):
    """The bucket plan of the bucketed path; None on the per-leaf path."""
    if not sync.bucketed:
        return None
    return bk.make_plan(pshapes, cols=sync.bucket_cols,
                        dense_below=sync.dense_below)


def init_train_state(model, tc: TrainConfig, *, device="cuda", seed: int = 0,
                     params=None):
    """Returns (params, memory, opt, count): the port's seeded init on
    ``device`` (or the given ``params``), zero float32 memory, the
    optimizer mode's zero state (see the module docstring), count 0. The
    memory is this worker's: a param-shaped tree on the per-leaf path and
    one (rows, cols) buffer per bucket on the bucketed path (the
    reference's carry a leading worker axis; in the port each worker's
    process holds its own)."""
    device = resolve_device(device)
    plan = _bucket_plan(_sync_config(tc), model.param_shapes())
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


def make_train_step(model, tc: TrainConfig):
    """Builds the train step (see the module docstring). It runs on the
    device its inputs lie on; ``step.sync``, ``step.plan`` (None on the
    per-leaf path) and ``step.col_axes`` are the validated sync config,
    the bucket plan and the per-leaf column axes it runs with."""
    sync = _sync_config(tc)
    pshapes = model.param_shapes()
    plan = _bucket_plan(sync, pshapes)
    col_axes = sync_col_axes(pshapes)
    eta_fn = _eta_schedule(tc)
    # adam_compressed: the memory accumulates raw gradients
    sync_eta = ((lambda t: 1.0) if tc.optimizer == "adam_compressed"
                else eta_fn)
    apply_optimizer = make_apply_optimizer(tc, eta_fn)

    def step(params, memory, opt, count, batch):
        leaves, treedef = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = model.loss(treedef.unflatten(live), batch)
        grads = torch.autograd.grad(loss, live)
        del live, loss
        if plan is not None:
            update, new_memory, _ = bucketed_sync_gradients(
                sync, plan, memory, treedef.unflatten(grads), sync_eta(count))
        else:
            update, new_memory, _ = sparse_sync_gradients(
                sync, memory, treedef.unflatten(grads), sync_eta(count),
                col_axes)
        del grads
        with torch.no_grad():
            opt = apply_optimizer(leaves, opt, count,
                                  treedef.flatten_up_to(update))
        return params, new_memory, opt, count + 1, _mean_metrics(metrics)

    step.sync, step.plan, step.col_axes = sync, plan, col_axes
    return step


def train(model, tc: TrainConfig, batches, n_steps: int, *, device="cuda",
          seed: int = 0, params=None, log_every: int = 10, telemetry=None):
    """End-to-end training loop on ``device`` (CUDA unless the caller asks
    for the CPU). ``batches``: iterator of batches already on ``device``
    (see ``repro_torch.data.DeviceBatcher``). Returns (params, memory,
    opt, count, history) with history the logged (step, loss) pairs.

    ``telemetry`` — a ``repro_torch.utils.telemetry.Telemetry`` sink fed
    every step's loss; when omitted an internal sink runs, so a NaN/inf
    loss raises ``NonFiniteLossError`` (carrying the partial ``history``)
    instead of training on garbage. Each step's device loss is read only
    after the NEXT step has been issued, so the host's read never waits
    on the step it just issued."""
    device = resolve_device(device)
    params, memory, opt, count = init_train_state(
        model, tc, device=device, seed=seed, params=params)
    step = make_train_step(model, tc)
    tel_owned = telemetry is None
    tel = telemetry if telemetry is not None else Telemetry()
    tel.set_bytes_per_step({"total": (
        bucketed_message_bytes(step.sync, step.plan) if step.plan is not None
        else message_bytes(step.sync, model.param_shapes(), step.col_axes))})
    history = []

    # one-step-late loss readback: float(loss) blocks until the step that
    # produced it has run, so it is drained only after the next step is
    # issued (detection and printing lag one step)
    pending = None

    def _drain(rec):
        idx, dev_loss, log_rec = rec
        loss = float(dev_loss)
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
        params, memory, opt, count, metrics = step(params, memory, opt,
                                                   count, batch)
        do_log = bool(log_every and (i % log_every == 0 or i == n_steps - 1))
        if pending is not None:
            _drain(pending)
        pending = (i, metrics["loss"], do_log)
        if tel.should_stop:
            print(f"telemetry early stop @ step {i}: {tel.stop_reason}")
            break
    if pending is not None:
        _drain(pending)  # the last issued step's loss
    if tel_owned:
        tel.close()
    return params, memory, opt, count, history


def _sync_from_args(ap, args) -> SyncConfig:
    """The sync config of the CLI. With ``--preset`` the named
    ``SyncConfig.preset`` bundle is the base and only flags given
    explicitly (other than their default) override it, as the reference's
    ``_sync_from_args`` does."""
    if args.preset is not None:
        overrides = {key: getattr(args, key)
                     for key in ("ratio", "strategy", "wire")
                     if getattr(args, key) != ap.get_default(key)}
        if args.bucketed:
            overrides["bucketed"] = True
        return SyncConfig.preset(args.preset, **overrides)
    return SyncConfig(ratio=args.ratio, strategy=args.strategy,
                      bucketed=args.bucketed, wire=args.wire)


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


def main(argv=None):
    """CLI: train an architecture's SMOKE variant end to end.

        python -m repro_torch.launch.train [--preset topk] [--bucketed]
            [--wire packed] [--platform cpu]
        torchrun --nproc_per_node 2 -m repro_torch.launch.train \
            --platform cpu --preset topk --ratio 0.02

    Each worker trains on its slice of the global ``--batch``; only rank
    0 prints.
    """
    from repro_torch.configs import ARCH_IDS, get_smoke_config
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
    ap.add_argument("--bucketed", action="store_true",
                    help="flat-buffer bucketed sync (repro_torch.core."
                         "buckets); without it, the per-leaf sync")
    ap.add_argument("--preset", default=None,
                    choices=("dense", "topk", "qsparse_local",
                             "pod_budgeted"),
                    help="start from a named SyncConfig.preset; other "
                         "sync flags given EXPLICITLY override its fields "
                         "(qsparse_local and pod_budgeted are not ported)")
    ap.add_argument("--wire", default="unpacked",
                    choices=("unpacked", "packed"),
                    help="sync wire format (repro_torch.core.encoding)")
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch, split over the workers")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="device to train on; 'cpu' runs every kernel's "
                         "plain version")
    args = ap.parse_args(argv)

    sync = _sync_from_args(ap, args)
    device = resolve_device(args.platform)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    made = _join_workers(args.platform)
    try:
        rank = torch.distributed.get_rank() if distributed() else 0
        cfg = get_smoke_config(args.arch)
        model = build_model(cfg)
        tc = TrainConfig(optimizer=args.optimizer, eta=args.eta, sync=sync)
        batches = ShardedBatcher(
            token_batches(cfg.vocab_size, args.batch, args.seq, seed=0),
            device)
        tel = Telemetry(printer=print if rank == 0 else lambda line: None)
        with tel:
            return train(model, tc, batches, n_steps=args.steps,
                         device=device, telemetry=tel)
    finally:
        if made:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
