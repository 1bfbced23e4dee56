"""The port's optimizers, schedules and theory against ``repro.optim`` and
``repro.core.theory``.

Schedules and stepsizes are host functions in the port, rounded in
float32 as the reference's traced ones: equal to the reference's float32
values for t in {0, 1, 7, 1000, 10^6} (``warmup_cosine`` within one ulp:
its cosine comes from another library). The bounds and shifts are plain
Python math in both, equal as floats. The transformations run 20 steps on
a tree of float32 leaves fed the same numpy gradients, their updates and
states within rtol 1e-6; ``WeightedAverage`` within rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import theory as RT
from repro.core.memsgd import constant_eta as ref_constant_eta
from repro import optim as RO
from repro.optim import schedules as RS
from repro_torch import optim as O
from repro_torch.core import theory as T
from repro_torch.core.memsgd import constant_eta
from repro_torch.optim import schedules as S

TS = (0, 1, 7, 1000, 10**6)


def _ref_at(sched, t):
    return float(sched(jnp.asarray(t, jnp.int32)))


SCHEDULES = {
    "constant": (lambda m: m.constant(0.37),),
    "inverse_time": (lambda m: m.inverse_time(2.0, 1 / 4000, 200.0),),
    "inverse_time rcv1": (lambda m: m.inverse_time(2.0, 1 / 20000,
                                                   47236.0 / 3),),
    "linear_decay": (lambda m: m.linear_decay(3e-3, 5000),),
    "warmup_cosine": (lambda m: m.warmup_cosine(0.1, 100, 10000, 1e-4),),
    "warmup_cosine no floor": (lambda m: m.warmup_cosine(3e-3, 7, 1000),),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    (make,) = SCHEDULES[name]
    ours, ref = make(S), make(RS)
    for t in TS:
        got, want = ours(t), _ref_at(ref, t)
        assert isinstance(got, float)
        if name.startswith("warmup_cosine"):
            assert abs(got - want) <= np.spacing(np.float32(want))
        else:
            assert got == want, (t, got, want)


STEPSIZES = {
    "paper epsilon": lambda m: m.paper_stepsize(2.0, 1 / 400000, 2000.0),
    "paper rcv1": lambda m: m.paper_stepsize(2.0, 1 / 20000,
                                             10 * 47236 / 30),
    "theorem": lambda m: m.theorem_stepsize(1.0, 7 * 64 / 4),
    "theorem mu": lambda m: m.theorem_stepsize(0.013, 311.5),
    "bottou": lambda m: m.bottou_stepsize(0.2, 1 / 4000),
    "bottou large": lambda m: m.bottou_stepsize(0.7, 1 / 3),
}


@pytest.mark.parametrize("name", list(STEPSIZES))
def test_stepsizes_match_reference(name):
    ours, ref = STEPSIZES[name](T), STEPSIZES[name](RT)
    for t in TS:
        assert ours(t) == _ref_at(ref, t), (t, ours(t), _ref_at(ref, t))


@pytest.mark.parametrize("eta", [0.5, 0.1, 1 / 3, 3e-3])
def test_constant_eta_matches_reference(eta):
    for t in TS:
        assert constant_eta(eta)(t) == _ref_at(ref_constant_eta(eta), t)


def test_theory_math_equals_reference():
    for d, k in [(2000, 1), (47236, 30), (64, 4.0), (1000, 0.5)]:
        assert T.theoretical_shift(d, k) == RT.theoretical_shift(d, k)
        assert T.theoretical_shift(d, k, 3.0) == RT.theoretical_shift(d, k,
                                                                      3.0)
        assert T.practical_shift(d, k, 10.0) == RT.practical_shift(d, k,
                                                                   10.0)
        for s in (None, 4, 16, 256):
            assert T.composed_contraction(d, k, s) == \
                RT.composed_contraction(d, k, s)
        for T_ in (1, 100, 800000):
            assert T.S_T(T_, d / k) == RT.S_T(T_, d / k)
            args = (T_, d, k, 0.1, 1.3, 4.0, 2.5)
            assert T.theorem_bound(*args) == RT.theorem_bound(*args)
            assert T.theorem_bound(*args, alpha=6.0) == \
                RT.theorem_bound(*args, alpha=6.0)
    for d, s in [(100, 4), (47236, 256)]:
        assert T.qsgd_variance_bound(d, s) == RT.qsgd_variance_bound(d, s)
    for H in (1, 4):
        assert T.local_steps_residual_factor(H) == \
            RT.local_steps_residual_factor(H)
    with pytest.raises(ValueError):
        T.local_steps_residual_factor(0)


@pytest.mark.parametrize("a", [2000.0, 472360.0 / 3, 1.0])
def test_weighted_average_matches_reference(a):
    """60 iterates, the weights (a + t)^2 accumulated in float32 in both
    (~2.5e10 at a = 157453)."""
    rng = np.random.default_rng(9)
    xs = rng.standard_normal((60, 300)).astype(np.float32)
    ours, ref = T.WeightedAverage(a), RT.WeightedAverage(a)
    s = ours.init(torch.zeros(300))
    rs = ref.init(jnp.zeros(300))
    for t, x in enumerate(xs):
        s = ours.update(s, torch.from_numpy(x), t)
        rs = ref.update(rs, jnp.asarray(x), jnp.asarray(t, jnp.int32))
    assert s[1] == float(rs[1])  # the total weight, in float32 in both
    np.testing.assert_allclose(ours.value(s).numpy(),
                               np.asarray(ref.value(rs)), rtol=1e-6)


SHAPES = {"a": (4, 5), "b": (7,), "c": {"d": (2, 3, 4)}}


def _tree(fn):
    return {"a": fn(SHAPES["a"]), "b": fn(SHAPES["b"]),
            "c": {"d": fn(SHAPES["c"]["d"])}}


TRANSFORMS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd schedule": lambda m: m.sgd(m.schedules.inverse_time(1.0, 0.5, 3.0)),
    "momentum": lambda m: m.sgd_momentum(0.05, beta=0.9),
    "nesterov": lambda m: m.sgd_momentum(0.05, beta=0.8, nesterov=True),
    "adam": lambda m: m.adam(3e-3),
    "adamw schedule": lambda m: m.adam(
        m.schedules.warmup_cosine(1e-2, 3, 20), weight_decay=0.01),
    "chain decay clip sgd": lambda m: m.chain(
        m.add_weight_decay(1e-2), m.clip_by_global_norm(1.5), m.sgd(0.2)),
    "chain scale_by_schedule": lambda m: m.chain(
        m.identity_tx(), m.scale(-0.5),
        m.scale_by_schedule(m.schedules.linear_decay(0.3, 15))),
}


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transformations_match_reference(name):
    """20 steps from the same params, fed the same gradients (each a
    function of the step's params, so the trajectories must agree), the
    params advanced by ``apply_updates``: params and state within rtol
    1e-6 at every step."""
    rng = np.random.default_rng(10)
    p0 = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    noise = [_tree(lambda s: rng.standard_normal(s).astype(np.float32))
             for _ in range(20)]
    ours, ref = TRANSFORMS[name](O), TRANSFORMS[name](RO)
    params = jax.tree.map(torch.from_numpy, p0)
    rparams = jax.tree.map(jnp.asarray, p0)
    s, rs = ours.init(params), ref.init(rparams)
    for n in noise:
        grads = jax.tree.map(lambda p, z: 0.3 * p + torch.from_numpy(z),
                             params, n)
        rgrads = jax.tree.map(lambda p, z: 0.3 * p + z, rparams, n)
        u, s = ours.update(grads, s, params=params)
        ru, rs = ref.update(rgrads, rs, params=rparams)
        params = O.apply_updates(params, u)
        rparams = RO.apply_updates(rparams, ru)
        for a, b in zip(_leaves_np(jax.tree.map(np.asarray, params)),
                        _leaves_np(rparams)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    tensors = [x for x in jax.tree.leaves(s) if isinstance(x, torch.Tensor)]
    r_arrays = [x for x in jax.tree.leaves(rs) if x.ndim > 0]
    assert len(tensors) == len(r_arrays)
    for a, b in zip(tensors, r_arrays):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    counts = [x for x in jax.tree.leaves(s) if isinstance(x, int)]
    assert counts == [int(x) for x in jax.tree.leaves(rs) if x.ndim == 0]


def test_apply_updates_keeps_each_params_dtype():
    params = {"w": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(2)}
    updates = {"w": torch.full((3,), 0.25), "b": torch.full((2,), 0.5)}
    out = O.apply_updates(params, updates)
    assert out["w"].dtype == torch.bfloat16 and out["b"].dtype == torch.float32
    assert out["w"].tolist() == [1.25] * 3 and params["w"].tolist() == [1.0] * 3
    with pytest.raises(ValueError):
        O.add_weight_decay(0.1).update({"b": torch.ones(2)}, ())
