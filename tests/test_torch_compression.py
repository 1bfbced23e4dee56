"""The port's compression operators and memory step against
``repro.core.compression`` / ``repro.core.memory``.

The same numpy vectors, made from a seed, go through both packages on the
CPU (the port's top-k runs its plain version there). ``top_k`` and
``blockwise_top_k`` promise the reference's selection contract
(decreasing |x|, ties to the lowest index), so their pairs and dense
forms are held bitwise, and so is ``memory_step``'s new memory for the
same u. ``rand_k`` and ``random_coordinate`` draw from torch's generators,
not the reference's threefry: they are held by the Definition 2.1
residual and by their selection frequencies over many draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as RC
from repro.core import memory as RM
from repro_torch.core import compression as C
from repro_torch.core import memory as M

# (kind, d, k): random, tie-heavy (halves, small integers), all-zero rows
# with signed zeros, a few nonzero entries among zeros
TOPK_CASES = [
    ("random", 200, 1), ("random", 2000, 3), ("random", 4733, 10),
    ("random", 257, 257), ("halves", 512, 40), ("integers", 1000, 30),
    ("zeros", 64, 10), ("sparse", 300, 12),
]
# (kind, d, k_per_block, block): d not a multiple of block pads the tail
BLOCK_CASES = [
    ("random", 4096, 2, 1024), ("random", 4733, 2, 1024),
    ("random", 100, 3, 16), ("halves", 1000, 5, 64),
    ("zeros", 70, 4, 32), ("sparse", 1500, 8, 256), ("random", 10, 3, 64),
]


def _vec(kind, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(d).astype(np.float32)
    if kind == "halves":
        x = np.round(x * 2) / 2
    elif kind == "integers":
        x = rng.integers(-3, 4, d).astype(np.float32)
    elif kind == "zeros":
        x = np.zeros(d, np.float32)
        x[1::3] = -0.0
    elif kind == "sparse":
        x = np.zeros(d, np.float32)
        x[::5] = -0.0
        x[rng.choice(d, 7, replace=False)] = rng.standard_normal(7)
    return np.ascontiguousarray(x, np.float32)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.int32)


def _assert_same_pairs_and_dense(port, ref, x):
    vals, idx = port.sparse(torch.from_numpy(x), None)
    rvals, ridx = ref.sparse(jnp.asarray(x), None)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(rvals))
    dense = port.dense(torch.from_numpy(x), None).numpy()
    np.testing.assert_array_equal(_bits(dense), _bits(ref.dense(
        jnp.asarray(x), None)))


@pytest.mark.parametrize("kind,d,k", TOPK_CASES)
def test_top_k_matches_reference(kind, d, k):
    x = _vec(kind, d, seed=d + k)
    _assert_same_pairs_and_dense(C.top_k(k), RC.top_k(k), x)
    assert C.top_k(k).k_of(d) == RC.top_k(k).k_of(d)


@pytest.mark.parametrize("kind,d,kb,block", BLOCK_CASES)
def test_blockwise_top_k_matches_reference(kind, d, kb, block):
    """Including the padded tail: its values zeroed, its indices clamped
    to 0, the dense form by add."""
    x = _vec(kind, d, seed=d + kb)
    _assert_same_pairs_and_dense(C.blockwise_top_k(kb, block),
                                 RC.blockwise_top_k(kb, block), x)
    assert (C.blockwise_top_k(kb, block).k_of(d)
            == RC.blockwise_top_k(kb, block).k_of(d))


@pytest.mark.parametrize("name,kw", [
    ("top_k", dict(k=7)), ("blockwise", dict(k_per_block=3, block=64)),
    ("identity", {}),
])
def test_memory_step_matches_reference(name, kw):
    """The same memory and gradient give the same u, applied update, new
    memory and pairs, bit for bit."""
    rng = np.random.default_rng(5)
    m = rng.standard_normal((12, 40)).astype(np.float32)
    g = rng.standard_normal((12, 40)).astype(np.float32)
    eta = 0.37
    got = M.memory_step(C.make_compressor(name, **kw), torch.from_numpy(m),
                        torch.from_numpy(g), eta)
    want = RM.memory_step(RC.make_compressor(name, **kw), jnp.asarray(m),
                          jnp.asarray(g), jnp.float32(eta))
    for a, b in ((got.applied, want.applied),
                 (got.new_memory, want.new_memory)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    for a, b in zip(got.sparse, want.sparse):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


def test_tree_memory_step_matches_reference():
    from repro.core.memsgd import leaf_compressor_from_ratio as ref_leaf
    from repro_torch.core.memsgd import leaf_compressor_from_ratio

    rng = np.random.default_rng(6)
    shapes = {"a": (16, 24), "b": (7,), "c": {"d": (3, 5, 8)}}

    def tree(fn):
        return {"a": fn(shapes["a"]), "b": fn(shapes["b"]),
                "c": {"d": fn(shapes["c"]["d"])}}

    m = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    g = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    applied, new_mem = M.tree_memory_step(
        leaf_compressor_from_ratio(0.1),
        jax.tree.map(torch.from_numpy, m), jax.tree.map(torch.from_numpy, g),
        0.5)
    r_applied, r_new_mem = RM.tree_memory_step(
        ref_leaf(0.1), jax.tree.map(jnp.asarray, m),
        jax.tree.map(jnp.asarray, g), jnp.float32(0.5))
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, applied)) +
                    jax.tree.leaves(jax.tree.map(np.asarray, new_mem)),
                    jax.tree.leaves(r_applied) + jax.tree.leaves(r_new_mem)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    zeros = M.init_memory(jax.tree.map(torch.from_numpy, m))
    assert all(not z.any() and z.dtype == torch.float32
               for z in jax.tree.leaves(zeros))


# the statistical checks: N draws from a seeded generator, for both
# packages (the reference from split keys)
N_DRAWS = 2000


def _mean_residual(dense_draw, x, n):
    return float(np.mean([np.sum((x - dense_draw(i)) ** 2)
                          for i in range(n)]))


@pytest.mark.parametrize("name,d,k", [
    ("rand_k", 64, 16), ("rand_k", 100, 1), ("random_coordinate", 64, 16.0),
    ("random_coordinate", 48, 0.5), ("random_coordinate", 32, 2.0),
])
def test_random_operators_contract_in_expectation(name, d, k):
    """Definition 2.1 with equality in expectation: over N_DRAWS draws,
    the mean residual ||x - comp(x)||^2 of each package lies within 5% of
    (1 - k/d)||x||^2."""
    x = _vec("random", d, seed=d)
    want = (1 - min(k, d) / d) * float(np.sum(x.astype(np.float64) ** 2))
    port = C.make_compressor(name, k=k)
    gen = torch.Generator().manual_seed(1)
    xt = torch.from_numpy(x)
    got = _mean_residual(lambda i: port.dense(xt, gen).numpy(), x, N_DRAWS)
    ref = RC.make_compressor(name, k=k)
    keys = jax.random.split(jax.random.PRNGKey(1), N_DRAWS)
    r_draws = np.asarray(jax.vmap(ref.dense, in_axes=(None, 0))(
        jnp.asarray(x), keys))
    r_got = _mean_residual(lambda i: r_draws[i], x, N_DRAWS)
    assert abs(got - want) <= 0.05 * want
    assert abs(r_got - want) <= 0.05 * want


@pytest.mark.parametrize("d,k", [(64, 16), (40, 3)])
def test_rand_k_draws_each_coordinate_with_frequency_k_over_d(d, k):
    """Over 4000 draws each coordinate is selected with frequency k/d
    within 0.03 (more than 4 standard deviations at these d, k), and each
    draw holds k distinct indices."""
    n = 4000
    gen = torch.Generator().manual_seed(2)
    x = torch.from_numpy(_vec("random", d))
    counts = np.zeros(d)
    for _ in range(n):
        vals, idx = C.rand_k(k).sparse(x, gen)
        assert idx.dtype == torch.int32 and len(set(idx.tolist())) == k
        assert torch.equal(vals, x[idx.long()])
        counts[idx.numpy()] += 1
    assert np.max(np.abs(counts / n - k / d)) < 0.03


def test_memory_step_draws_once_for_both_forms():
    """rand_k's dense and sparse forms of one memory_step select the same
    coordinates (the reference shares one key between them): the applied
    update is the pairs densified, and the new memory is zero exactly
    there."""
    d, k = 50, 6
    rng = np.random.default_rng(7)
    m = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    for _ in range(20):
        upd = M.memory_step(C.rand_k(k), m, g, 0.5, gen)
        vals, idx = upd.sparse
        nz = torch.nonzero(upd.applied).reshape(-1)
        assert sorted(nz.tolist()) == sorted(idx.tolist())
        assert torch.equal(upd.applied[idx.long()], vals)
        assert not upd.new_memory[idx.long()].any()
        u = m + 0.5 * g
        assert torch.equal(upd.new_memory + upd.applied, u)
        m = upd.new_memory


def test_random_coordinate_has_no_sparse_form_and_draws_from_its_generator():
    x = torch.from_numpy(_vec("random", 200))
    comp = C.random_coordinate(20.0)
    assert comp.sparse is None and comp.needs_rng
    a = comp.dense(x, torch.Generator().manual_seed(4))
    b = comp.dense(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.equal(a[kept], x[kept])


def test_identity_registry_and_residual_match_reference():
    x = _vec("random", 33)
    _assert_same_pairs_and_dense(C.identity(), RC.identity(), x)
    for name, kw in [("top_k", dict(k=3)), ("rand_k", dict(k=3)),
                     ("blockwise", dict(k_per_block=2, block=16)),
                     ("random_coordinate", dict(k=0.5)), ("identity", {})]:
        ours, ref = C.make_compressor(name, **kw), RC.make_compressor(name, **kw)
        assert (ours.name, ours.needs_rng, ours.sparse is None) == \
            (ref.name, ref.needs_rng, ref.sparse is None)
        assert ours.k_of(1000) == ref.k_of(1000)
    with pytest.raises(ValueError):
        C.make_compressor("nope")
    y = _vec("halves", 33, seed=1)
    got = C.contraction_residual(torch.from_numpy(x), torch.from_numpy(y))
    want = RC.contraction_residual(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert C.top_k_ratio(0.01)(2000) == RC.top_k_ratio(0.01)(2000)
