"""Qsparse-local-SGD in the port (local steps and the quantized sync) at
one worker, in process, against ``repro.core.buckets.accumulate_local``,
``repro.core.distributed.bucketed_sync_gradients(quant_key=)`` under
``jax.vmap`` at axis size 1 and ``repro.launch.train``'s two jitted steps.

* ``accumulate_local`` within 1e-6 of the reference's (its own test's
  tolerance);
* invariant 12: the accumulator path at H = 1 (``init_local_accum``,
  ``accumulate_local`` at eta, the sync of the accumulator through
  ``grad_bufs=`` at eta 1.0) gives the direct sync's update and memory bit
  for bit, on the flat, the two-level and the runtime-k chains (a (1, 1)
  layout without a process group), and ``local_quant_selfcheck`` holds
  there;
* the quantized bucketed sync on the reference's uniforms (injected:
  ``_ref_quant_noise.RefNoise``), its bytes equal (by level too): on the
  flat chain and dyadic values (j/8, eta 1/2, so u and every sum of
  squares are exact) the update and the memory bit for bit; on random
  values within 1e-6 (the reference's FMA allowance on u); on the
  two-level chains, whose level-2 norm sums dequantized values in XLA's
  order or the port's (2 ulp apart, which each dequantized value
  carries), within 1e-6 plus 4e-7 of the tensor's largest |value|;
* ``make_train_step`` at H = 4 (``step.accum`` three times, then the sync
  step) and at ``microbatch`` 2, on the qwen3-4b smoke config in float32
  compute from the reference's init, against the reference's jitted steps
  on its 1x1 mesh with the port drawing the reference's uniforms: losses
  within rtol 1e-5 and the applied update and the memory within relative
  L2 1e-3 (``tests/test_torch_train.py``'s tolerances: the frameworks'
  gradients differ in their last bits, which moves u and can flip a rare
  near-tie in the selection);
* ``train()``'s cadence: a sync every H-th step, the bytes a step
  ``amortized_bytes_per_step``, the local steps leaving params and memory
  as they were.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ref_quant_noise import RefNoise

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core import buckets as rbk
from repro.core.distributed import PodConfig as RPodConfig
from repro.core.distributed import SyncConfig as RSyncConfig
from repro.core.distributed import WireConfig as RWireConfig
from repro.core.distributed import bucketed_message_bytes as r_bucket_bytes
from repro.core.distributed import bucketed_sync_gradients as r_bucketed
from repro.launch.train import TrainConfig as RTrainConfig
from repro.launch.train import init_train_state as r_init_train_state
from repro.launch.train import make_train_step as r_make_train_step
from repro.launch.train import state_shardings as r_state_shardings
from repro.models import build_model as ref_build_model
from repro.utils.compat import make_mesh
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import buckets as bk
from repro_torch.core.distributed import (
    PodConfig,
    SyncConfig,
    WireConfig,
    amortized_bytes_per_step,
    bucketed_message_bytes,
    bucketed_sync_gradients,
)
from repro_torch.core.selfcheck import bitwise_equal, local_quant_selfcheck
from repro_torch.data import take, token_batches
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import Layout
from repro_torch.models import build_model
from repro_torch.optim.qsgd import QuantNoise
from repro_torch.utils.telemetry import Telemetry
from repro_torch.utils.tree import tree_leaves

COLS = 256
S = 15
SEED, STEP = 4, 7
# a (1, 1) (pod, data) layout: the two-level chain gathers over no group
LAYOUT = Layout(n_pods=1, n_data=1, rank=0, data_group=None, pod_group=None)
PATHS = ("flat", "hierarchical", "pod_dynamic")


def _tree_np(seed, dyadic=False):
    rng = np.random.default_rng(seed)

    def f32(*s):
        if dyadic:
            return (rng.integers(-64, 65, s) / 8).astype(np.float32)
        return rng.standard_normal(s).astype(np.float32)

    return {"w1": f32(64, 300), "w2": f32(3, 40, 100), "b": f32(64)}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _plans():
    shapes = _tree_np(0)
    return (bk.make_plan(_torch(shapes), cols=COLS),
            rbk.make_plan(jax.tree.map(jnp.asarray, shapes), cols=COLS))


def _cfgs(path, wire="packed", quant=S):
    """(the port's config, the reference's) of a path: the flat chain, the
    two-level one at pod ratio 0.05, the runtime-k one (its live k 7)."""
    kw = dict(ratio=0.03, bucketed=True, bucket_cols=COLS,
              strategy="sparse_allgather" if path == "flat"
              else "hierarchical")
    pod = {} if path == "flat" else dict(axis="pod", ratio=0.05,
                                         dynamic=path == "pod_dynamic")
    return (SyncConfig(**kw, pod=PodConfig(**pod),
                       wire=WireConfig(wire=wire, quant=quant)),
            RSyncConfig(**kw, pod=RPodConfig(**pod),
                        wire=RWireConfig(wire=wire, quant=quant)))


def _pod_ks(plan, k=7):
    return tuple(k if s.kind == "sparse" else 1 for s in plan.buckets)


def _inputs(dyadic):
    plan, _ = _plans()
    rng = np.random.default_rng(5)
    if dyadic:
        mem = [(rng.integers(-64, 65, s.shape) / 8).astype(np.float32)
               for s in plan.buckets]
    else:
        mem = [rng.standard_normal(s.shape).astype(np.float32)
               for s in plan.buckets]
    return mem, _tree_np(6, dyadic)


def test_accumulate_local_matches_reference():
    plan, rplan = _plans()
    acc = bk.init_local_accum(plan)
    racc = rbk.init_local_accum(rplan)
    for i, eta in enumerate((0.3, 0.1, 0.05)):
        g = _tree_np(10 + i)
        acc = bk.accumulate_local(plan, acc, _torch(g), eta)
        racc = rbk.accumulate_local(rplan, racc,
                                    jax.tree.map(jnp.asarray, g), eta)
    for a, b in zip(acc, racc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("quant", [None, S])
def test_h1_accumulator_is_bitwise_the_direct_sync(path, quant):
    plan, _ = _plans()
    cfg = _cfgs(path, quant=quant)[0]
    mem, g = _inputs(dyadic=False)
    kw = dict(layout=None if path == "flat" else LAYOUT,
              pod_ks=_pod_ks(plan) if path == "pod_dynamic" else None,
              quant_noise=QuantNoise(SEED, STEP) if quant else None)
    direct = bucketed_sync_gradients(cfg, plan, _torch_list(mem), _torch(g),
                                     0.3, **kw)
    acc = bk.accumulate_local(plan, bk.init_local_accum(plan), _torch(g),
                              0.3)
    routed = bucketed_sync_gradients(cfg, plan, _torch_list(mem), None, 1.0,
                                     grad_bufs=acc, **kw)
    assert bitwise_equal(direct[:2], routed[:2]) and direct[2] == routed[2]


def _torch_list(bufs):
    return [torch.from_numpy(b.copy()) for b in bufs]


def test_local_quant_selfcheck_at_one_worker():
    out = local_quant_selfcheck(LAYOUT)
    assert out["quant_conservation_max_err"] < 1e-5
    assert all(v for k, v in out.items() if k != "quant_conservation_max_err")


@functools.lru_cache(maxsize=None)
def _reference_fn(path):
    """The reference's quantized sync at one worker under vmap (nested
    over (pod, data) for the two-level chains) on the packed wire (its
    packed and unpacked wires give the same bits), with its quant_key
    fold_in(PRNGKey(SEED), STEP), compiled: (memory, grads, eta) ->
    (update, memory), each with its leading worker axes."""
    _, rplan = _plans()
    rcfg = _cfgs(path)[1]
    qkey = jax.random.fold_in(jax.random.PRNGKey(SEED), STEP)
    ks = (jnp.asarray(_pod_ks(rplan), jnp.int32) if path == "pod_dynamic"
          else None)

    def fn(m, gt, eta):
        return r_bucketed(rcfg, rplan, m, gt, eta, pod_ks=ks,
                          quant_key=qkey)[:2]

    if path == "flat":
        return jax.jit(jax.vmap(fn, (0, 0, None), axis_name="data"))
    return jax.jit(jax.vmap(jax.vmap(fn, (0, 0, None), axis_name="data"),
                            (0, 0, None), axis_name="pod"))


@functools.lru_cache(maxsize=None)
def _reference_sync(path, dyadic):
    """``_reference_fn``'s (update leaves, memory buffers) without the
    worker axes, and the reference's bytes."""
    _, rplan = _plans()
    mem, g = _inputs(dyadic)
    lead = (None,) * (1 if path == "flat" else 2)
    upd, new_mem = _reference_fn(path)(
        tuple(jnp.asarray(b)[lead] for b in mem),
        jax.tree.map(lambda x: jnp.asarray(x)[lead], g),
        jnp.float32(0.5 if dyadic else 0.3))
    kw = dict(n_data=1) if path == "pod_dynamic" else {}
    return ([np.asarray(x).reshape(np.shape(x)[len(lead):])
             for x in jax.tree.leaves(upd)],
            [np.asarray(x).reshape(np.shape(x)[len(lead):])
             for x in new_mem],
            r_bucket_bytes(_cfgs(path)[1], rplan, **kw))


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "random"])
@pytest.mark.parametrize("wire", ["packed", "unpacked"])
@pytest.mark.parametrize("path", PATHS)
def test_quantized_sync_matches_reference(path, wire, dyadic):
    plan, _ = _plans()
    cfg = _cfgs(path, wire)[0]
    mem, g = _inputs(dyadic)
    noise = RefNoise(SEED, STEP, n_data=None if path == "flat" else 1)
    level = {"intra": 0, "cross": 0}
    upd, new_mem, nbytes = bucketed_sync_gradients(
        cfg, plan, _torch_list(mem), _torch(g), 0.5 if dyadic else 0.3,
        layout=None if path == "flat" else LAYOUT,
        pod_ks=_pod_ks(plan) if path == "pod_dynamic" else None,
        quant_noise=noise, level_bytes=level)
    r_upd, r_mem, r_nbytes = _reference_sync(path, dyadic)
    assert nbytes == (r_nbytes if wire == "packed" else
                      bucketed_message_bytes(cfg, plan, n_data=1))
    ours = tree_leaves(upd) + list(new_mem)
    assert len(ours) == len(r_upd) + len(r_mem)
    for a, b in zip(ours, r_upd + r_mem):
        a = a.numpy()
        if dyadic and path == "flat":
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
        elif path == "flat":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:  # the level-2 norm of dequantized values: 2 ulp apart
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-6 + 4e-7 * np.abs(b).max())
    if path != "flat":  # the bytes each level realized
        want = bucketed_message_bytes(cfg, plan, by_level=True, n_data=1)
        assert level == {"intra": want["intra"], "cross": want["cross"]}


# ---------------------------------------------------------------------------
# the train step: local steps and microbatches against the reference's
# ---------------------------------------------------------------------------

ARCH = "qwen3-4b"


def _ref_steps(rmodel, rtc, batches, H):
    """The reference's jitted steps on a 1x1 (data, model) mesh: its
    ``step.accum`` then ``step`` at H > 1 (the accumulator as its
    ``train()`` lays it out), else ``step``. Returns (params before, as
    numpy, params after, memory without the worker axis, losses)."""
    mesh = make_mesh((1, 1), ("data", "model"))
    params, memory, opt, count = r_init_train_state(
        rmodel, mesh, rtc, rng=jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.array, params)
    pshard, mshard, _, _ = r_state_shardings(rmodel, mesh, rtc)
    params, memory = (jax.device_put(params, pshard),
                      jax.device_put(memory, mshard))
    step = r_make_train_step(rmodel, mesh, rtc)
    assert step.local_steps == H
    plan = rbk.make_plan(rmodel.param_shapes(), cols=1024)
    acc = jax.device_put(tuple(jnp.zeros((1,) + s.shape, jnp.float32)
                               for s in plan.buckets), mshard)
    losses = []
    for i, b in enumerate(batches):
        b = {k: jnp.asarray(v) for k, v in b.items()}
        if H == 1:
            params, memory, opt, count, met = step(params, memory, opt,
                                                   count, b)
        else:
            f = step if (i + 1) % H == 0 else step.accum
            params, memory, acc, opt, count, met = f(params, memory, acc,
                                                     opt, count, b)
        losses.append(met["loss"])
    return (params_np, params, [np.asarray(m)[0] for m in memory],
            [float(x) for x in losses])


def _port_steps(tc, params_np, batches, monkeypatch):
    """The port's steps on the same batches from the reference's init,
    its rounding noise the reference's draws."""
    monkeypatch.setattr(train_mod, "QuantNoise", RefNoise)
    model = build_model(get_smoke_config(ARCH).replace(
        compute_dtype="float32", n_layers=1))
    p, m, o, c = train_mod.init_train_state(model, tc, device="cpu",
                                            params=params_from_jax(params_np))
    step = train_mod.make_train_step(model, tc)
    H = step.local_steps
    acc = bk.init_local_accum(step.plan)
    losses = []
    for i, b in enumerate(batches):
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        if H == 1:
            p, m, o, c, met = step(p, m, o, c, b)
        elif (i + 1) % H == 0:
            p, m, acc, o, c, met = step(p, m, acc, o, c, b)
        else:
            before = [x.clone() for x in tree_leaves(p)] + list(m)
            p, m, acc, o, c, met = step.accum(p, m, acc, o, c, b)
            assert bitwise_equal(before, tree_leaves(p) + list(m))
        losses.append(met["loss"])
    assert c == len(batches)
    return p, m, [float(x) for x in losses]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(leaves):
    return np.concatenate([np.asarray(x).reshape(-1) for x in leaves])


@pytest.mark.parametrize("H,microbatch", [(4, 1), (1, 2)],
                         ids=["local_steps=4", "microbatch=2"])
def test_train_step_matches_reference(H, microbatch, monkeypatch):
    """qsparse_local (k = 20 of 1024, s = 15, packed) at H = 4 through
    ``step.accum`` and the sync step; the bucketed Mem-SGD step at
    microbatch 2 (the reference's scan over the chunks)."""
    batches = list(take(token_batches(512, 4, 32, seed=1), H + 1))
    if H > 1:
        sync = SyncConfig.preset("qsparse_local", ratio=0.02)
        rsync = RSyncConfig.preset("qsparse_local", ratio=0.02)
        batches = batches[:H]
    else:
        sync = SyncConfig(ratio=0.02, bucketed=True)
        rsync = RSyncConfig(ratio=0.02, bucketed=True)
    rmodel = ref_build_model(ref_get_smoke_config(ARCH).replace(
        compute_dtype="float32", n_layers=1))
    rtc = RTrainConfig(eta=0.5, sync=rsync, quant_seed=3,
                       microbatch=microbatch)
    params_np, r_params, r_mem, r_losses = _ref_steps(rmodel, rtc, batches,
                                                      H)
    tc = train_mod.TrainConfig(eta=0.5, sync=sync, quant_seed=3,
                               microbatch=microbatch)
    p, m, losses = _port_steps(tc, params_np, batches, monkeypatch)
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    before = _flat(jax.tree.leaves(params_np))
    assert _rel_l2(before - _flat([x.numpy() for x in tree_leaves(p)]),
                   before - _flat(jax.tree.leaves(r_params))) < 1e-3
    assert _rel_l2(_flat([x.numpy() for x in m]), _flat(r_mem)) < 1e-3


def test_train_runs_the_local_step_cadence():
    """train() on the qsparse_local preset: 6 steps at H = 4 end after a
    local step, one sync in; the telemetry's bytes a step are
    amortized_bytes_per_step, a quarter of the sync's."""
    model = build_model(get_smoke_config(ARCH))
    sync = SyncConfig.preset("qsparse_local", ratio=0.02)
    tc = train_mod.TrainConfig(eta=0.5, sync=sync)
    tel = Telemetry(printer=lambda line: None)
    calls = []
    real = train_mod.bucketed_sync_gradients

    def spy(*a, **kw):
        calls.append(kw["quant_noise"].step)
        return real(*a, **kw)

    train_mod.bucketed_sync_gradients = spy
    try:
        _, memory, _, count, history = train_mod.train(
            model, tc, ({k: torch.from_numpy(v) for k, v in b.items()}
                        for b in take(token_batches(model.cfg.vocab_size, 4,
                                                    32, seed=0), 6)), 6,
            device="cpu",
            telemetry=tel, log_every=1)
    finally:
        train_mod.bucketed_sync_gradients = real
    assert count == 6 and calls == [3] and len(history) == 6
    plan = bk.make_plan(model.param_shapes(), cols=1024)
    assert tel.bytes_per_step == {"total": amortized_bytes_per_step(sync,
                                                                    plan)}
    assert tel.bytes_per_step["total"] * 4 == bucketed_message_bytes(sync,
                                                                     plan)
    assert all(np.isfinite([x for _, x in history]))
