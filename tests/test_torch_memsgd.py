"""The port's Mem-SGD transformations against ``repro.core.memsgd``, the
paper's logistic regression against the reference's numpy runner, and
the torch quickstart.

Trajectories: the same numpy data, made from a seed, drive both packages
for 50 steps on the CPU; each iterate within rtol 1e-5 (atol 1e-6 of the
iterate's largest entry, for entries near zero). The paper check: the
port's float32 ``memsgd_flat`` on the paper's protocol reaches the
suboptimality of ``benchmarks/logreg_runners.run_memsgd`` (numpy float64)
within 2%, on the same sample indices.
"""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as RC
from repro.core import theory as RT
from repro.data.synthetic import make_epsilon_like, make_rcv1_like
from repro.optim import apply_updates as ref_apply_updates
from repro_torch.core import compression as C
from repro_torch.core import theory as T
from repro_torch.core.memsgd import (
    constant_eta,
    leaf_compressor_from_ratio,
    memsgd,
    memsgd_flat,
)
from repro_torch.data import (
    logreg_grad_np,
    logreg_grad_torch,
    logreg_loss_np,
    logreg_loss_torch,
)
from repro_torch.data import make_epsilon_like as port_epsilon
from repro_torch.data import make_rcv1_like as port_rcv1
from repro_torch.optim import apply_updates, sgd

# the module (``repro.core`` exports a function of the same name)
RMS = importlib.import_module("repro.core.memsgd")
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load(relpath):
    path = os.path.join(ROOT, relpath)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _assert_iterates_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-6 * float(np.max(np.abs(want))))


def _logreg_problem(n=300, d=60):
    data = make_epsilon_like(n=n, d=d, seed=3)
    A32, b32 = data.A.astype(np.float32), data.b.astype(np.float32)
    idx = np.random.default_rng(4).integers(n, size=50)

    def ref_grad(x, t):
        a, bi = jnp.asarray(A32[idx[t]]), jnp.float32(b32[idx[t]])
        sig = jax.nn.sigmoid(-bi * jnp.dot(a, x))
        return -(bi * sig) * a + jnp.float32(data.lam) * x

    def port_grad(x, t):
        return logreg_grad_torch(torch.from_numpy(A32),
                                 torch.from_numpy(b32), data.lam, x,
                                 int(idx[t]))

    return data, ref_grad, port_grad


@pytest.mark.parametrize("problem,k", [("quadratic", 4), ("quadratic", 1),
                                       ("logreg", 3)])
def test_memsgd_flat_trajectory_matches_reference(problem, k):
    """50 steps of memsgd_flat(top_k(k)): a quadratic at a constant eta,
    and logistic regression at the paper's stepsize (each package's
    ``paper_stepsize``)."""
    if problem == "quadratic":
        d = 64
        target = np.random.default_rng(k).standard_normal(d).astype(
            np.float32)
        port_sched = constant_eta(0.5 * k / d)
        ref_sched = RMS.constant_eta(0.5 * k / d)

        def ref_grad(x, t):
            return x - jnp.asarray(target)

        def port_grad(x, t):
            return x - torch.from_numpy(target)
    else:
        data, ref_grad, port_grad = _logreg_problem()
        d = data.d
        port_sched = T.paper_stepsize(2.0, data.lam, d / k)
        ref_sched = RT.paper_stepsize(2.0, data.lam, d / k)
    port = memsgd_flat(C.top_k(k), port_sched, d)
    ref = RMS.memsgd_flat(RC.top_k(k), ref_sched, d)
    x, rx = torch.zeros(d), jnp.zeros(d)
    s, rs = port.init(x), ref.init(rx)
    for t in range(50):
        u, s = port.update(port_grad(x, t), s)
        x = apply_updates(x, u)
        ru, rs = ref.update(ref_grad(rx, t), rs)
        rx = ref_apply_updates(rx, ru)
        _assert_iterates_close(x.numpy(), rx)
    assert s.count == 50
    _assert_iterates_close(s.memory.numpy(), rs.memory)


def test_memsgd_tree_trajectory_matches_reference():
    """50 steps of the per-leaf memsgd on a quadratic over a tree of
    leaves of several shapes, k = round(0.2 * size) per leaf."""
    rng = np.random.default_rng(8)
    shapes = {"a": (4, 4), "b": (7,), "c": {"d": (3, 9)}}
    target = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    port = memsgd(leaf_compressor_from_ratio(0.2), constant_eta(0.3))
    ref = RMS.memsgd(RMS.leaf_compressor_from_ratio(0.2),
                     RMS.constant_eta(0.3))
    params = jax.tree.map(lambda a: torch.zeros(a.shape), target)
    rparams = jax.tree.map(lambda a: jnp.zeros(a.shape), target)
    s, rs = port.init(params), ref.init(rparams)
    for _ in range(50):
        grads = jax.tree.map(lambda p, tg: p - torch.from_numpy(tg), params,
                             target)
        u, s = port.update(grads, s)
        params = apply_updates(params, u)
        rgrads = jax.tree.map(lambda p, tg: p - tg, rparams, target)
        ru, rs = ref.update(rgrads, rs)
        rparams = ref_apply_updates(rparams, ru)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(rparams)):
            _assert_iterates_close(a.numpy(), b)


@pytest.mark.parametrize("mode", ["top_k", "rand_k", "blockwise"])
def test_leaf_compressor_from_ratio_matches_reference(mode):
    for shape in [(7,), (40, 50), (3, 1000)]:
        ours = leaf_compressor_from_ratio(0.02, block=256, mode=mode)(
            torch.zeros(shape))
        ref = RMS.leaf_compressor_from_ratio(0.02, block=256, mode=mode)(
            jnp.zeros(shape))
        assert ours.name == ref.name
    with pytest.raises(ValueError):
        leaf_compressor_from_ratio(0.1, mode="nope")(torch.zeros(4))


def test_memsgd_equals_sgd_when_k_is_d():
    """With the identity compressor (k=d) Mem-SGD IS vanilla SGD, and
    the memory stays exactly zero."""
    d, eta = 16, 0.1
    target = torch.linspace(-1, 1, d)
    tx_mem = memsgd_flat(C.identity(), constant_eta(eta), d)
    tx_sgd = sgd(eta)
    w1, w2 = torch.zeros(d), torch.zeros(d)
    s1, s2 = tx_mem.init(w1), tx_sgd.init(w2)
    for _ in range(25):
        u1, s1 = tx_mem.update(w1 - target, s1)
        u2, s2 = tx_sgd.update(w2 - target, s2)
        w1, w2 = apply_updates(w1, u1), apply_updates(w2, u2)
    assert torch.equal(w1, w2)
    assert not s1.memory.any()


def test_eta_applied_at_insertion_time():
    """Gradients are scaled by eta_t when they ENTER memory: with eta = 0
    at the second step, only the memory moves w, carrying the OLD eta."""
    tx = memsgd_flat(C.top_k(1), lambda t: 1.0 if t == 0 else 0.0, 2)
    w = torch.zeros(2)
    s = tx.init(w)
    g = torch.tensor([2.0, 1.0])
    u, s = tx.update(g, s)
    w = apply_updates(w, u)
    assert w.tolist() == [-2.0, 0.0]
    u, s = tx.update(g, s)
    w = apply_updates(w, u)
    assert w.tolist() == [-2.0, -1.0]


def test_rand_k_memsgd_converges_and_its_generator_is_the_states():
    """memsgd_flat(rand_k) converges on the quadratic (the reference's
    test_memsgd_converges_on_quadratic_randk), and two runs from one
    seed draw the same coordinates."""
    d, k = 64, 4
    target = torch.ones(d)

    def run(seed, steps):
        tx = memsgd_flat(C.rand_k(k), constant_eta(0.5 * k / d), d,
                         seed=seed)
        w = torch.zeros(d)
        s = tx.init(w)
        for _ in range(steps):
            u, s = tx.update(w - target, s)
            w = apply_updates(w, u)
        return w, s

    w, s = run(3, 3000)
    assert float(torch.linalg.norm(w - target)) < 1e-2
    assert isinstance(s.rng, torch.Generator)
    assert torch.equal(run(5, 20)[0], run(5, 20)[0])
    assert not torch.equal(run(5, 20)[0], run(6, 20)[0])


def _optimum(data, iters=2000):
    """f* as ``benchmarks/logreg_runners.reference_optimum`` finds it (its
    2000 full gradient steps at 1/L, in float64), with the gradient's
    sum over samples as a matrix-vector product instead of a temporary
    (n, d) array: the same iterates up to rounding, in a tenth of the
    time."""
    L = 0.25 * float((data.A**2).sum(axis=1).max()) + data.lam
    x = np.zeros(data.d)
    for _ in range(iters):
        sig = 1.0 / (1.0 + np.exp(data.b * (data.A @ x)))
        g = -(data.A.T @ (data.b * sig)) / data.n + data.lam * x
        x = x - g / L
    return logreg_loss_np(data, x)


@pytest.mark.parametrize("name", ["epsilon-small", "rcv1-small"])
def test_paper_check_matches_the_numpy_runner(name):
    """The paper's protocol (eta_t = 2 / (lam (t + a)), weighted average
    w_t = (t + a)^2, T = 2n, top-k) on the examples' small datasets: the
    port's float32 memsgd_flat reaches run_memsgd's suboptimality (numpy
    float64, argpartition) within 2% on the same sample indices."""
    runners = _load("benchmarks/logreg_runners.py")
    example = _load("examples/torch_logreg_paper.py")
    if name == "epsilon-small":
        data, k, a = make_epsilon_like(n=4_000, d=200), 1, 200.0
        port_data = port_epsilon(n=4_000, d=200)
    else:
        data, k = make_rcv1_like(n=2_000, d=2_000, density=0.01), 10
        port_data = port_rcv1(n=2_000, d=2_000, density=0.01)
        a = 10.0 * data.d / k
    # one seed gives both packages the same data
    np.testing.assert_array_equal(port_data.A, data.A)
    np.testing.assert_array_equal(port_data.b, data.b)
    T_steps = 2 * data.n
    fstar = _optimum(data)
    want = runners.run_memsgd(data, T_steps, k=k, comp="top", a=a)
    A, b = example.to_device(data, "cpu")
    xbar, _ = example.run_memsgd_flat(
        A, b, data.lam, C.top_k(k), a, example.sample_indices(data.n,
                                                               T_steps))
    got = logreg_loss_np(data, xbar.double().numpy()) - fstar
    assert abs(got - (want.final_loss - fstar)) <= 0.02 * (
        want.final_loss - fstar)


def test_logreg_loss_and_gradient_twins_match_numpy():
    data = port_rcv1(n=50, d=300, density=0.05, seed=2)
    x = np.random.default_rng(1).standard_normal(data.d) * 0.3
    A, b = torch.from_numpy(data.A), torch.from_numpy(data.b)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(float(logreg_loss_torch(A, b, data.lam, xt)),
                               logreg_loss_np(data, x), rtol=1e-12)
    for idx in (7, np.array([3, 9, 9, 41])):
        want = logreg_grad_np(data, x, idx if not isinstance(idx, int)
                              else [idx])
        got = logreg_grad_torch(A, b, data.lam, xt, idx if isinstance(
            idx, int) else torch.from_numpy(idx))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-15)


def test_torch_quickstart_converges():
    assert _load("examples/torch_quickstart.py").main(
        ["--platform", "cpu"]) < 0.01
