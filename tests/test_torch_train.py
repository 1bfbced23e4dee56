"""The port's train step and driver against ``repro.launch.train``.

One Mem-SGD step of a smoke config (qwen3-4b, and rwkv6-3b,
granite-moe-3b-a800m, qwen3-moe-30b-a3b and recurrentgemma-9b at 3 layers
on each path) in float32
compute, on the bucketed path, the per-leaf path and the topk
preset, from the reference's init, on the reference's 1-device mesh (the
``tests/test_system.py`` pattern) and in the port on the CPU. Tolerances:
loss within rtol 1e-5; the applied update (params before minus after)
within relative L2 error 1e-3 — gradients differ in the last bits between
the frameworks, which can flip a rare near-tie in |g| (the sync test holds
the selection itself bitwise). The selection is discontinuous, so a
free-running trajectory also measures chaos: the reference's own float32
losses move by up to 5.7e-4 relative (qwen3-4b, eta 0.5) or 7.5e-3
(rwkv6-3b, eta 0.05) within six steps when its init is nudged by 1e-6
relative. qwen3-4b's six-step per-leaf trajectory therefore runs free at
eta 0.5 with its losses within rtol 2e-3; rwkv6-3b's (at eta 0.5 its
reference run reaches NaN at step 5) runs at eta 0.05 with each port step
taken from the reference's params and memory before it, held to the
one-step tolerances.

rwkv6-3b's and recurrentgemma-9b's reference steps are assembled from
the reference's own parts (``_ref_step_from_parts``): the reference's
jitted driver step does not trace them in float32 compute on the
installed JAX (inside its ``shard_map``, ``wkv_chunked``'s
``jnp.tril(jnp.ones(...))`` and ``rg_lru``'s ``jnp.ones_like`` raise a
context-mesh error; bfloat16 compute traces).
"""
import io
import math
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as P

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core import buckets as rbk
from repro.core.distributed import SyncConfig as RefSyncConfig
from repro.core.distributed import bucketed_sync_gradients as ref_bucket_sync
from repro.core.distributed import sparse_sync_gradients as ref_leaf_sync
from repro.launch.train import TrainConfig as RefTrainConfig
from repro.launch.train import _eta_schedule as ref_eta_schedule
from repro.launch.train import init_train_state as ref_init_train_state
from repro.launch.train import make_train_step as ref_make_train_step
from repro.launch.train import state_shardings as ref_state_shardings
from repro.launch.sharding import sync_col_axes as ref_sync_col_axes
from repro.models import build_model as ref_build_model
from repro.utils.compat import make_mesh, shard_map
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import (
    memory_from_jax,
    memory_to_jax,
    opt_from_jax,
    params_from_jax,
)
from repro_torch.core.buckets import make_plan
from repro_torch.core.distributed import SyncConfig
from repro_torch.data import DeviceBatcher, take, token_batches
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import (
    TrainConfig,
    _eta_schedule,
    init_train_state,
    make_train_step,
    train,
)
from repro_torch.models import build_model
from repro_torch.utils.telemetry import NonFiniteLossError, Telemetry
from repro_torch.utils.tree import tree_leaves

ARCH = "qwen3-4b"
# (the port's sync, the reference's) of each path
PATHS = {
    "bucketed": (SyncConfig(ratio=0.01, bucketed=True),
                 RefSyncConfig(ratio=0.01, bucketed=True)),
    "per-leaf": (SyncConfig(ratio=0.01), RefSyncConfig(ratio=0.01)),
    "topk preset": (SyncConfig.preset("topk", ratio=0.02),
                    RefSyncConfig.preset("topk", ratio=0.02)),
}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _ref_driver_steps(rmodel, rtc, batches):
    """The reference's jitted train step on a 1x1 (data, model) mesh.
    Returns (params before as numpy, params after, memory, losses)."""
    mesh = make_mesh((1, 1), ("data", "model"))
    params, memory, opt, count = ref_init_train_state(
        rmodel, mesh, rtc, rng=jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.array, params)  # copied before donation
    pshard, mshard, _, _ = ref_state_shardings(rmodel, mesh, rtc)
    step = ref_make_train_step(rmodel, mesh, rtc)
    params, memory = (jax.device_put(params, pshard),
                      jax.device_put(memory, mshard))
    losses = []
    for b in batches:
        params, memory, opt, count, metrics = step(
            params, memory, opt, count,
            {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(metrics["loss"])
    assert int(count) == len(batches)
    return params_np, params, memory, [float(x) for x in losses]


def _ref_step_from_parts(rmodel, rtc, batches, states=None):
    """The reference's memsgd step from its parts, as its driver composes
    them at one worker: ``model.loss`` gradients (jitted, no mesh), the
    sync (``bucketed_sync_gradients`` over its plan, or
    ``sparse_sync_gradients`` along its column axes) inside a 1-device
    ``shard_map``, params - update. Same returns as _ref_driver_steps (the
    memory without a worker axis); appends each step's (params, memory)
    before it, as numpy, to ``states`` when given."""
    sync_cfg = rtc.sync
    params_np = jax.tree.map(
        np.asarray, rmodel.init(jax.random.PRNGKey(0)))
    pshapes = rmodel.param_shapes()
    eta = jnp.float32(rtc.eta)
    if sync_cfg.bucketed:
        plan = rbk.make_plan(pshapes, cols=sync_cfg.bucket_cols,
                             dense_below=sync_cfg.dense_below)
        memory = tuple(jnp.zeros(s.shape, jnp.float32) for s in plan.buckets)

        def body(mem, grads):
            return ref_bucket_sync(sync_cfg, plan, mem, grads, eta)[:2]
    else:
        cols = ref_sync_col_axes(pshapes)
        memory = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                              pshapes)

        def body(mem, grads):
            return ref_leaf_sync(sync_cfg, mem, grads, eta, cols)[:2]

    spec = lambda t: jax.tree.map(lambda _: P(), t)  # noqa: E731
    sync = jax.jit(shard_map(
        body, mesh=jax.make_mesh((1,), ("data",)),
        in_specs=(spec(memory), spec(pshapes)),
        out_specs=(spec(pshapes), spec(memory))))
    grad_fn = jax.jit(jax.value_and_grad(rmodel.loss, has_aux=True))
    params = jax.tree.map(jnp.asarray, params_np)
    losses = []
    for b in batches:
        if states is not None:
            states.append(jax.tree.map(np.array, (params, memory)))
        (_, metrics), grads = grad_fn(
            params, {k: jnp.asarray(v) for k, v in b.items()})
        update, memory = sync(memory, grads)
        params = jax.tree.map(lambda p, u: p - u.astype(p.dtype), params,
                              update)
        losses.append(metrics["xent"])
    return params_np, params, memory, [float(x) for x in losses]


def _both_steps(arch, path, n_steps, **overrides):
    """``n_steps`` memsgd steps of ``arch``'s smoke config in float32
    compute (and ``overrides``), in the reference (one jitted shard_map
    step on a 1x1 (data, model) mesh) and in the port on the CPU, from the
    same params and batches. Returns the port's and the reference's
    (losses, applied update, memory)."""
    cfg_kw = dict(compute_dtype="float32", **overrides)
    sync, ref_sync = PATHS[path]
    batches = list(take(token_batches(512, 4, 64, seed=1), n_steps))

    rmodel = ref_build_model(ref_get_smoke_config(arch).replace(**cfg_kw))
    rtc = RefTrainConfig(optimizer="memsgd", eta=0.5, sync=ref_sync)
    ref_steps = (_ref_step_from_parts
                 if rmodel.cfg.family in ("rwkv", "hybrid")
                 else _ref_driver_steps)
    params_np, r_params, r_memory, r_losses = ref_steps(rmodel, rtc,
                                                        batches)

    model = build_model(get_smoke_config(arch).replace(**cfg_kw))
    tc = TrainConfig(optimizer="memsgd", eta=0.5, sync=sync)
    p, m, o, c = init_train_state(model, tc, device="cpu",
                                  params=params_from_jax(params_np))
    port_step = make_train_step(model, tc)
    losses = []
    for b in batches:
        p, m, o, c, metrics = port_step(
            p, m, o, c, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]

    assert c == n_steps
    before = np.concatenate([x.reshape(-1) for x in jax.tree.leaves(params_np)])
    got = before - np.concatenate([x.numpy().reshape(-1)
                                   for x in tree_leaves(p)])
    want = before - np.concatenate([np.asarray(x).reshape(-1)
                                    for x in jax.tree.leaves(r_params)])
    return (losses, got, m), (r_losses, want, r_memory)


def _one_step_both(bucketed):
    """One qwen3-4b step of the bucketed or the per-leaf path (see
    _both_steps), each side's loss as a number."""
    got, want = _both_steps(ARCH, "bucketed" if bucketed else "per-leaf", 1)
    return (got[0][0],) + got[1:], (want[0][0],) + want[1:]


def _assert_step_agrees(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert np.count_nonzero(want[1]) > 0
    assert _rel_l2(got[1], want[1]) < 1e-3


def test_one_step_matches_reference():
    got, want = _one_step_both(bucketed=True)
    _assert_step_agrees(got, want)
    m, r_memory = got[2], want[2]
    model = build_model(get_smoke_config(ARCH))
    kinds = [s.kind for s in make_plan(model.param_shapes()).buckets]
    assert [x.shape for x in memory_to_jax(m)] == [b.shape for b in r_memory]
    for a, b, kind in zip(m, memory_from_jax(r_memory), kinds):
        a, b = a.numpy(), b.numpy()
        if kind == "sparse":
            assert _rel_l2(a, b) < 1e-3
        else:  # a dense bucket ships all of u: nothing stays
            assert not a.any() and not b.any()


def test_per_leaf_step_matches_reference():
    got, want = _one_step_both(bucketed=False)
    _assert_step_agrees(got, want)
    m, r_memory = got[2], want[2]
    assert [x.shape for x in jax.tree.leaves(memory_to_jax(m))] == \
        [b.shape for b in jax.tree.leaves(r_memory)]
    for a, b in zip(tree_leaves(m), tree_leaves(memory_from_jax(r_memory))):
        a, b = a.numpy(), b.numpy()
        if a.size >= SyncConfig().dense_below:
            assert _rel_l2(a, b) < 1e-3
        else:  # a dense leaf ships all of u: nothing stays
            assert not a.any() and not b.any()


def _main_on_the_cpu(path_args):
    out = io.StringIO()
    with redirect_stdout(out):
        params, memory, opt, count, history = train_mod.main(
            ["--platform", "cpu", *path_args, "--steps", "3", "--batch", "2",
             "--seq", "32"])
    assert count == 3
    assert [i for i, _ in history] == [0, 2]  # logs the first and last
    assert all(math.isfinite(x) for _, x in history)
    assert "step     2" in out.getvalue()
    return memory


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-30b-a3b"])
def test_moe_one_step_matches_reference(arch, path):
    """The MoE smoke configs (40 and 128 experts cut to 4, top-2; the 4-D
    expert leaves and the router on each path's selection), against the
    reference's jitted driver step, which traces them in float32."""
    got, want = _both_steps(arch, path, 1)
    _assert_step_agrees((got[0][0],) + got[1:], (want[0][0],) + want[1:])


@pytest.mark.parametrize("path", list(PATHS))
def test_rwkv_one_step_matches_reference(path):
    """rwkv6-3b's smoke config (24 leaves, 2 buckets) on each path."""
    got, want = _both_steps("rwkv6-3b", path, 1)
    _assert_step_agrees((got[0][0],) + got[1:], (want[0][0],) + want[1:])


@pytest.mark.parametrize("path", list(PATHS))
def test_griffin_one_step_matches_reference(path):
    """recurrentgemma-9b's smoke config at 3 layers (rec, rec, attn: every
    block kind; the blocks a list of per-layer trees) on each path."""
    got, want = _both_steps("recurrentgemma-9b", path, 1, n_layers=3)
    _assert_step_agrees((got[0][0],) + got[1:], (want[0][0],) + want[1:])


def _free_running_trajectory(arch):
    """Six per-leaf steps at eta 0.5, each package from its own state:
    the losses within rtol 2e-3 (the reference's own chaos is 5.7e-4,
    above), and the port's losses fall."""
    got, want = _both_steps(arch, "per-leaf", 6)
    losses, r_losses = got[0], want[0]
    np.testing.assert_allclose(losses, r_losses, rtol=2e-3)
    assert losses[-1] < losses[0]


def _re_anchored_trajectory(arch):
    """Six per-leaf steps at eta 0.05 along the reference's trajectory:
    each port step from the reference's params and memory before it gives
    its loss within rtol 1e-5 and its update within relative L2 1e-3, and
    the port's losses fall."""
    sync, ref_sync = PATHS["per-leaf"]
    batches = list(take(token_batches(512, 4, 64, seed=1), 6))
    rmodel = ref_build_model(
        ref_get_smoke_config(arch).replace(compute_dtype="float32"))
    states = []
    *_, r_losses = _ref_step_from_parts(
        rmodel, RefTrainConfig(optimizer="memsgd", eta=0.05, sync=ref_sync),
        batches, states)
    model = build_model(get_smoke_config(arch).replace(
        compute_dtype="float32"))
    port_step = make_train_step(
        model, TrainConfig(optimizer="memsgd", eta=0.05, sync=sync))

    def flat(leaves):
        return np.concatenate([np.asarray(x).reshape(-1) for x in leaves])

    losses, errors = [], []
    # each step from the reference's state before it, its update held
    # against the reference's next state (the last step has none)
    for i, (b, (params_np, memory_np), after) in enumerate(
            zip(batches, states, states[1:] + [None])):
        p, _, _, _, metrics = port_step(
            params_from_jax(params_np), params_from_jax(memory_np), (),
            count=i, batch={k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(metrics["loss"])
        if after is not None:
            before = flat(jax.tree.leaves(params_np))
            errors.append(_rel_l2(before - flat(tree_leaves(p)),
                                  before - flat(jax.tree.leaves(after[0]))))
    losses = [float(x) for x in losses]
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    assert max(errors) < 1e-3
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-3b"])
def test_six_step_loss_trajectory_matches_reference(arch):
    """Six steps of the per-leaf path (the driver's default), the
    reference compiled once: qwen3-4b free-running, rwkv6-3b along the
    reference's trajectory (its float32 smoke training is chaotic)."""
    if arch == "rwkv6-3b":
        _re_anchored_trajectory(arch)
    else:
        _free_running_trajectory(arch)


def test_main_trains_on_the_cpu():
    assert isinstance(_main_on_the_cpu(["--bucketed"]), tuple)


def test_main_trains_the_per_leaf_path_on_the_cpu():
    memory = _main_on_the_cpu([])  # no --bucketed: the per-leaf sync
    assert isinstance(memory, dict)
    model = build_model(get_smoke_config(ARCH))
    assert [m.shape for m in tree_leaves(memory)] == \
        [p.shape for p in tree_leaves(model.param_shapes())]


def test_main_trains_moe_on_the_cpu():
    memory = _main_on_the_cpu(["--arch", "granite-moe-3b-a800m"])
    model = build_model(get_smoke_config("granite-moe-3b-a800m"))
    assert [m.shape for m in tree_leaves(memory)] == \
        [p.shape for p in tree_leaves(model.param_shapes())]


def test_main_trains_rwkv_on_the_cpu():
    memory = _main_on_the_cpu(["--arch", "rwkv6-3b"])
    model = build_model(get_smoke_config("rwkv6-3b"))
    assert [m.shape for m in tree_leaves(memory)] == \
        [p.shape for p in tree_leaves(model.param_shapes())]


def test_main_trains_griffin_on_the_cpu():
    memory = _main_on_the_cpu(["--arch", "recurrentgemma-9b"])
    model = build_model(get_smoke_config("recurrentgemma-9b"))
    assert isinstance(memory["blocks"], list)
    assert [m.shape for m in tree_leaves(memory)] == \
        [p.shape for p in tree_leaves(model.param_shapes())]


def test_train_feeds_every_loss_to_telemetry():
    model = build_model(get_smoke_config(ARCH))
    tc = TrainConfig(eta=0.5, sync=SyncConfig(ratio=0.01, bucketed=True))
    batches = DeviceBatcher(token_batches(512, 2, 32, seed=0), "cpu")
    with Telemetry(printer=lambda s: None) as tel:
        *_, count, _ = train(model, tc, batches, 3, device="cpu",
                             telemetry=tel)
    assert count == 3
    assert len(tel.losses) == 3 and all(math.isfinite(x) for x in tel.losses)
    assert tel.summary()["bytes_per_step"]["total"] > 0


def test_nonfinite_loss_stops_training_with_its_history():
    model = build_model(get_smoke_config(ARCH))
    tc = TrainConfig(eta=0.5, sync=SyncConfig(ratio=0.01, bucketed=True))
    params = model.init(seed=0, device="cpu")
    params["ln_f"].fill_(float("nan"))
    batches = DeviceBatcher(token_batches(512, 2, 16, seed=0), "cpu")
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(NonFiniteLossError) as e:
        train(model, tc, batches, 3, device="cpu", params=params)
    assert e.value.step == 0 and e.value.history == []


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        train_mod.main(["--bucketed", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no GPU"):
        train_mod.main(["--steps", "1"])
    model = build_model(get_smoke_config(ARCH))
    tc = TrainConfig(sync=SyncConfig(bucketed=True))
    with pytest.raises(RuntimeError, match="no GPU"):
        train(model, tc, iter(()), 1)


@pytest.mark.parametrize("tc,err", [
    # the ids of the cases from before local steps and the quantized wire
    # were ported: on the per-leaf path they are refused, as the reference
    # refuses them
    pytest.param(TrainConfig(sync=SyncConfig(overlap=True, local_steps=4)),
                 ValueError, id="tc0-NotImplementedError"),
    pytest.param(TrainConfig(sync=SyncConfig(wire="packed", quant=4)),
                 ValueError, id="tc1-NotImplementedError"),
    pytest.param(TrainConfig(optimizer="sgd",
                             sync=SyncConfig(bucketed=True)),
                 ValueError, id="tc2-ValueError"),
])
def test_unported_or_unknown_settings_raise(tc, err):
    model = build_model(get_smoke_config(ARCH))
    with pytest.raises(err):
        make_train_step(model, tc)


# the optimizer modes beyond memsgd and their stepsizes: momentum 0.9 at
# eta 0.05 (eta / (1 - 0.9) = 0.5, the memsgd tests' step); Adam at the
# reference's own system-test rate
OPT_MODES = {"memsgd_momentum": 0.05, "adam_compressed": 3e-3}


def _ref_driver_states(rmodel, rtc, batches):
    """The reference's jitted driver step on a 1x1 (data, model) mesh.
    Returns its (params, memory, opt) as numpy before each step and after
    the last, and its losses."""
    mesh = make_mesh((1, 1), ("data", "model"))
    state = ref_init_train_state(rmodel, mesh, rtc,
                                 rng=jax.random.PRNGKey(0))
    shardings = ref_state_shardings(rmodel, mesh, rtc)
    params, memory, opt, count = (jax.device_put(x, s)
                                  for x, s in zip(state, shardings))
    step = ref_make_train_step(rmodel, mesh, rtc)
    states, losses = [], []
    for b in batches:  # copied before the step donates them
        states.append(jax.tree.map(np.array, (params, memory, opt)))
        params, memory, opt, count, metrics = step(
            params, memory, opt, count,
            {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(metrics["loss"])
    states.append(jax.tree.map(np.array, (params, memory, opt)))
    return states, [float(x) for x in losses]


def _flat(leaves):
    return np.concatenate([np.asarray(x).reshape(-1) for x in leaves])


@pytest.mark.parametrize("path", ["bucketed", "per-leaf"])
@pytest.mark.parametrize("mode", list(OPT_MODES))
def test_optimizer_modes_match_reference(mode, path):
    """Two steps of memsgd_momentum / adam_compressed on the qwen3-4b
    smoke config in float32 compute, the port from the reference's init
    and optimizer state (``convert``): the losses within rtol 1e-5 and
    the applied update within relative L2 1e-3 over both steps (the
    tolerances of _assert_step_agrees), and so is the port's second step
    taken from the reference's state after its first (a nonzero optimizer
    state carried across), its optimizer state included."""
    sync, ref_sync = PATHS[path]
    batches = list(take(token_batches(512, 4, 64, seed=1), 2))
    cfg_kw = dict(compute_dtype="float32")
    rmodel = ref_build_model(ref_get_smoke_config(ARCH).replace(**cfg_kw))
    states, r_losses = _ref_driver_states(
        rmodel, RefTrainConfig(optimizer=mode, eta=OPT_MODES[mode],
                               sync=ref_sync), batches)

    model = build_model(get_smoke_config(ARCH).replace(**cfg_kw))
    tc = TrainConfig(optimizer=mode, eta=OPT_MODES[mode], sync=sync)
    port_step = make_train_step(model, tc)

    def port_state(i):
        params_np, memory_np, opt_np = states[i]
        return (params_from_jax(params_np), memory_from_jax(memory_np),
                opt_from_jax(opt_np))

    def batch(i):
        return {k: torch.from_numpy(v) for k, v in batches[i].items()}

    p, m, o = port_state(0)
    c, losses = 0, []
    for i in range(2):
        p, m, o, c, metrics = port_step(p, m, o, c, batch(i))
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]
    before = _flat(jax.tree.leaves(states[0][0]))
    want = before - _flat(jax.tree.leaves(states[2][0]))
    _assert_step_agrees(
        (losses, before - _flat(x.numpy() for x in tree_leaves(p))),
        (r_losses, want))
    assert _rel_l2(_flat(x.numpy() for x in tree_leaves(o)),
                   _flat(jax.tree.leaves(states[2][2]))) < 1e-3

    # the second step from the reference's state after its first
    p, m, o = port_state(1)
    assert np.count_nonzero(_flat(x.numpy() for x in tree_leaves(o))) > 0
    p, m, o, _, metrics = port_step(p, m, o, 1, batch(1))
    before = _flat(jax.tree.leaves(states[1][0]))
    _assert_step_agrees(
        (float(metrics["loss"]), before - _flat(x.numpy()
                                                for x in tree_leaves(p))),
        (r_losses[1], before - _flat(jax.tree.leaves(states[2][0]))))
    assert _rel_l2(_flat(x.numpy() for x in tree_leaves(o)),
                   _flat(jax.tree.leaves(states[2][2]))) < 1e-3


@pytest.mark.parametrize("mode", list(OPT_MODES))
def test_main_trains_the_optimizer_modes_on_the_cpu(mode):
    out = io.StringIO()
    with redirect_stdout(out):
        params, memory, opt, count, history = train_mod.main(
            ["--platform", "cpu", "--optimizer", mode, "--eta",
             str(OPT_MODES[mode]), "--steps", "3", "--batch", "2", "--seq",
             "32"])
    assert count == 3 and all(math.isfinite(x) for _, x in history)
    assert isinstance(opt, dict)
    shapes = [p.shape for p in tree_leaves(params)]
    if mode == "adam_compressed":
        assert set(opt) == {"mu", "nu"}
        assert [x.shape for x in tree_leaves(opt["mu"])] == shapes
    else:
        assert [x.shape for x in tree_leaves(opt)] == shapes


@pytest.mark.parametrize("eta,shift", [(0.5, 0.0), (0.37, 10.0), (1.3, 3.0)])
def test_eta_schedule_matches_reference(eta, shift):
    """The host schedule rounds as the reference's traced one does."""
    ours = _eta_schedule(TrainConfig(eta=eta, eta_shift=shift))
    ref = ref_eta_schedule(RefTrainConfig(eta=eta, eta_shift=shift))
    for t in (0, 1, 7, 1000):
        assert ours(t) == float(ref(jnp.asarray(t, jnp.int32)))


def _cli_call(argv):
    """The model and train config the port's CLI builds from ``argv`` (its
    own parser, captured at the call of ``train``)."""
    seen = {}
    real = train_mod.train

    def keep(model, tc, *a, **kw):
        seen["model"], seen["tc"] = model, tc
        return None

    train_mod.train = keep
    try:
        train_mod.main(["--platform", "cpu", *argv])
    finally:
        train_mod.train = real
    return seen["model"], seen["tc"]


def _cli_sync(argv):
    """The sync config the port's CLI builds from ``argv``."""
    return _cli_call(argv)[1].sync


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cli_arch_reaches_every_ported_arch(arch):
    model, _ = _cli_call(["--arch", arch])
    assert model.cfg == get_smoke_config(arch)


@pytest.mark.parametrize("argv,name,overrides", [
    (["--preset", "topk"], "topk", {}),
    (["--preset", "topk", "--ratio", "0.02"], "topk", dict(ratio=0.02)),
    (["--preset", "topk", "--wire", "unpacked", "--ratio", "0.02"], "topk",
     dict(ratio=0.02)),  # --wire's default is not an explicit override
    (["--preset", "dense", "--bucketed"], "dense", dict(bucketed=True)),
    (["--preset", "dense", "--strategy", "sparse_allgather", "--ratio",
      "0.05"], "dense", dict(ratio=0.05)),
    (["--preset", "pod_budgeted", "--byte-budget", "185587",
      "--pod-mass-target", "0.8"], "pod_budgeted",
     dict(byte_budget=185587, pod_mass_target=0.8)),
    (["--preset", "topk", "--overlap", "on"], "topk", dict(overlap=True)),
    (["--preset", "pod_budgeted", "--overlap", "off"], "pod_budgeted",
     dict(overlap=False)),
    (["--preset", "topk", "--overlap", "auto"], "topk", {}),
    (["--preset", "qsparse_local"], "qsparse_local", {}),
    (["--preset", "qsparse_local", "--local-steps", "2", "--wire-quant",
      "3", "--wire", "unpacked"], "qsparse_local",
     dict(local_steps=2, quant=3)),
])
def test_cli_preset_matches_reference(argv, name, overrides):
    """Explicit flags override the preset's fields, as the reference's
    ``_sync_from_args`` does (a flag left at its default does not)."""
    got = _cli_sync(argv)
    want = RefSyncConfig.preset(name, **overrides)
    for field in ("strategy", "ratio", "bucketed", "wire", "value_dtype",
                  "k_min", "k_max", "local_steps", "quant", "pod_ratio",
                  "pod_mass_target", "pod_dynamic", "pod_k_max_ratio",
                  "repack", "byte_budget", "overlap"):
        assert getattr(got, field) == getattr(want, field), field


def test_cli_unported_preset_raises_by_name():
    """Every preset of the reference's is ported (qsparse_local with its
    flags since local steps and the quantized wire were): the CLI builds
    the reference's config for it, and an unknown preset name raises by
    name."""
    got = _cli_sync(["--preset", "qsparse_local", "--ratio", "0.02",
                     "--wire-quant", "7", "--local-steps", "2"])
    want = RefSyncConfig.preset("qsparse_local", ratio=0.02, quant=7,
                                local_steps=2)
    for field in ("strategy", "ratio", "bucketed", "wire", "local_steps",
                  "quant"):
        assert getattr(got, field) == getattr(want, field), field
    with pytest.raises(ValueError, match="bogus"):
        SyncConfig.preset("bogus")


def test_main_trains_the_topk_preset_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        *_, memory, _, count, history = train_mod.main(
            ["--platform", "cpu", "--preset", "topk", "--ratio", "0.02",
             "--steps", "2", "--batch", "2", "--seq", "32"])
    assert count == 2 and isinstance(memory, tuple)
    assert all(math.isfinite(x) for _, x in history)


def test_sharded_batcher_gives_each_rank_its_slice():
    from repro_torch.data import ShardedBatcher

    batches = list(take(token_batches(512, 4, 8, seed=0), 2))
    for rank in range(2):
        # iter(): the batcher itself refuses list(), as the reference's
        got = list(iter(ShardedBatcher(iter(batches), "cpu", rank=rank,
                                       world=2)))
        for b, full in zip(got, batches):
            for k, v in full.items():
                np.testing.assert_array_equal(
                    b[k].numpy(), v[2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="does not divide"):
        next(iter(ShardedBatcher(iter(batches), "cpu", rank=0, world=3)))
    one = next(iter(ShardedBatcher(iter(batches), "cpu")))  # no group: all
    np.testing.assert_array_equal(one["tokens"].numpy(),
                                  batches[0]["tokens"])
