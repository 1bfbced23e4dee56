"""The port's train step and driver against ``repro.launch.train``.

One Mem-SGD step of the qwen3-4b smoke config in float32 compute, on the
bucketed and on the per-leaf path, from the reference's init, on the
reference's 1-device mesh (the ``tests/test_system.py`` pattern) and in the
port on the CPU. Tolerances:
loss within rtol 1e-5; the applied update (params before minus after)
within relative L2 error 1e-3 — gradients differ in the last bits between
the frameworks, which can flip a rare near-tie in |g| (the sync test holds
the selection itself bitwise).
"""
import io
import math
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core.distributed import SyncConfig as RefSyncConfig
from repro.launch.train import TrainConfig as RefTrainConfig
from repro.launch.train import _eta_schedule as ref_eta_schedule
from repro.launch.train import init_train_state as ref_init_train_state
from repro.launch.train import make_train_step as ref_make_train_step
from repro.launch.train import state_shardings as ref_state_shardings
from repro.models import build_model as ref_build_model
from repro.utils.compat import make_mesh
from repro_torch.configs import get_smoke_config
from repro_torch.convert import memory_from_jax, memory_to_jax, params_from_jax
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


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _one_step_both(bucketed):
    """One memsgd step of the smoke config in float32 compute, in the
    reference (jitted shard_map step on a 1x1 (data, model) mesh) and in
    the port on the CPU, from the same params and batch. Returns the
    port's and the reference's (loss, applied update, memory)."""
    cfg_kw = dict(compute_dtype="float32")
    batch_np = next(token_batches(512, 4, 64, seed=1))

    mesh = make_mesh((1, 1), ("data", "model"))
    rmodel = ref_build_model(ref_get_smoke_config(ARCH).replace(**cfg_kw))
    rtc = RefTrainConfig(optimizer="memsgd", eta=0.5,
                         sync=RefSyncConfig(ratio=0.01, bucketed=bucketed))
    params, memory, opt, count = ref_init_train_state(
        rmodel, mesh, rtc, rng=jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.array, params)  # copied before donation
    pshard, mshard, _, _ = ref_state_shardings(rmodel, mesh, rtc)
    step = ref_make_train_step(rmodel, mesh, rtc)
    r_params, r_memory, _, r_count, r_metrics = step(
        jax.device_put(params, pshard), jax.device_put(memory, mshard), opt,
        count, {k: jnp.asarray(v) for k, v in batch_np.items()})

    model = build_model(get_smoke_config(ARCH).replace(**cfg_kw))
    tc = TrainConfig(optimizer="memsgd", eta=0.5,
                     sync=SyncConfig(ratio=0.01, bucketed=bucketed))
    p, m, o, c = init_train_state(model, tc, device="cpu",
                                  params=params_from_jax(params_np))
    port_step = make_train_step(model, tc)
    p, m, o, c, metrics = port_step(
        p, m, o, c, {k: torch.from_numpy(v) for k, v in batch_np.items()})

    assert c == int(r_count) == 1
    before = np.concatenate([x.reshape(-1) for x in jax.tree.leaves(params_np)])
    got = before - np.concatenate([x.numpy().reshape(-1)
                                   for x in tree_leaves(p)])
    want = before - np.concatenate([np.asarray(x).reshape(-1)
                                    for x in jax.tree.leaves(r_params)])
    return ((float(metrics["loss"]), got, m),
            (float(r_metrics["loss"]), want, r_memory))


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


def test_main_trains_on_the_cpu():
    assert isinstance(_main_on_the_cpu(["--bucketed"]), tuple)


def test_main_trains_the_per_leaf_path_on_the_cpu():
    memory = _main_on_the_cpu([])  # no --bucketed: the per-leaf sync
    assert isinstance(memory, dict)
    model = build_model(get_smoke_config(ARCH))
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
    (TrainConfig(sync=SyncConfig(strategy="hierarchical")),
     NotImplementedError),  # the per-leaf path, two-level sync
    (TrainConfig(optimizer="adam_compressed",
                 sync=SyncConfig(bucketed=True)), NotImplementedError),
    (TrainConfig(optimizer="sgd", sync=SyncConfig(bucketed=True)),
     ValueError),
])
def test_unported_or_unknown_settings_raise(tc, err):
    model = build_model(get_smoke_config(ARCH))
    with pytest.raises(err):
        make_train_step(model, tc)


@pytest.mark.parametrize("eta,shift", [(0.5, 0.0), (0.37, 10.0), (1.3, 3.0)])
def test_eta_schedule_matches_reference(eta, shift):
    """The host schedule rounds as the reference's traced one does."""
    ours = _eta_schedule(TrainConfig(eta=eta, eta_shift=shift))
    ref = ref_eta_schedule(RefTrainConfig(eta=eta, eta_shift=shift))
    for t in (0, 1, 7, 1000):
        assert ours(t) == float(ref(jnp.asarray(t, jnp.int32)))


def _cli_sync(argv):
    """The sync config the port's CLI builds from ``argv`` (its own
    parser, captured at the step)."""
    seen = {}
    real = train_mod.train

    def keep(model, tc, *a, **kw):
        seen["sync"] = tc.sync
        return None

    train_mod.train = keep
    try:
        train_mod.main(["--platform", "cpu", *argv])
    finally:
        train_mod.train = real
    return seen["sync"]


@pytest.mark.parametrize("argv,name,overrides", [
    (["--preset", "topk"], "topk", {}),
    (["--preset", "topk", "--ratio", "0.02"], "topk", dict(ratio=0.02)),
    (["--preset", "topk", "--wire", "unpacked", "--ratio", "0.02"], "topk",
     dict(ratio=0.02)),  # --wire's default is not an explicit override
    (["--preset", "dense", "--bucketed"], "dense", dict(bucketed=True)),
    (["--preset", "dense", "--strategy", "sparse_allgather", "--ratio",
      "0.05"], "dense", dict(ratio=0.05)),
])
def test_cli_preset_matches_reference(argv, name, overrides):
    """Explicit flags override the preset's fields, as the reference's
    ``_sync_from_args`` does (a flag left at its default does not)."""
    got = _cli_sync(argv)
    want = RefSyncConfig.preset(name, **overrides)
    for field in ("strategy", "ratio", "bucketed", "wire", "value_dtype",
                  "k_min", "k_max", "local_steps", "quant"):
        assert getattr(got, field) == getattr(want, field), field


def test_cli_unported_preset_raises_by_name():
    with pytest.raises(NotImplementedError, match="qsparse_local"):
        train_mod.main(["--platform", "cpu", "--preset", "qsparse_local"])


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
        got = list(ShardedBatcher(iter(batches), "cpu", rank=rank, world=2))
        for b, full in zip(got, batches):
            for k, v in full.items():
                np.testing.assert_array_equal(
                    b[k].numpy(), v[2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="does not divide"):
        next(iter(ShardedBatcher(iter(batches), "cpu", rank=0, world=3)))
    one = next(iter(ShardedBatcher(iter(batches), "cpu")))  # no group: all
    np.testing.assert_array_equal(one["tokens"].numpy(),
                                  batches[0]["tokens"])
