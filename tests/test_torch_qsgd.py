"""The port's QSGD quantizer, its quantized wire tier, the quant-aware
accounting and the grouped ``SyncConfig`` against the reference's
(``repro.optim.qsgd``, ``repro.core.encoding``, ``repro.core.distributed``).

The quantizer is held in three tiers, as torch cannot draw JAX's threefry
noise and XLA's order for the row norm's sum is its compiler's:

* bitwise, on the reference's own uniforms (``jax.random.uniform`` of its
  key, injected) and dyadic values j/8 (|j| <= 64), where every partial
  sum of squares is exact in float32 whatever the order: the norms, the
  codes and the dequantized values;
* within a tolerance on random values: norms within 2 ulp; every code the
  reference's except where the reference's p_up lies within 1e-5 of its
  uniform, where one level either way is allowed (counted and printed);
* always, with the port's own ``QuantNoise``: E[deq] == vals within 5
  sigma over 4000 draws.

The wire's bytes (``encode``, ``decode``, ``decode_quant``, ``repack``,
``repad``) equal the reference's on the same codes, indices and norms (a
hypothesis sweep), and the accounting (``WireSpec`` words,
``message_nbytes``, ``bucketed_message_bytes``,
``amortized_bytes_per_step``) equals it on a grid, qwen3-4b's
full-width bucket among it.
"""
import contextlib
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro.configs import get_config as ref_get_config
from repro.core import buckets as rbk
from repro.core import encoding as renc
from repro.core.distributed import PodConfig as RPodConfig
from repro.core.distributed import SyncConfig as RSyncConfig
from repro.core.distributed import WireConfig as RWireConfig
from repro.core.distributed import amortized_bytes_per_step as r_amortized
from repro.core.distributed import bucketed_message_bytes as r_bucket_bytes
from repro.models import build_model as ref_build_model
from repro.optim.qsgd import quantize_rows as r_quantize_rows
from repro_torch.configs import get_config
from repro_torch.core import buckets as bk
from repro_torch.core import encoding as enc
from repro_torch.core.distributed import (
    PodConfig,
    SyncConfig,
    TransportConfig,
    WireConfig,
    amortized_bytes_per_step,
    bucketed_message_bytes,
)
from repro_torch.models import build_model
from repro_torch.optim import apply_updates
from repro_torch.optim.qsgd import QuantNoise, qsgd, qsgd_quantize, \
    quantize_rows

QMAX = enc._QUANT_MAX


@contextlib.contextmanager
def _no_deprecation():
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        yield


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


@functools.partial(jax.jit, static_argnums=1)
def _ref_quantize_jit(vals, s, seed):
    """The reference's quantize_rows on PRNGKey(seed), and the uniforms
    its bernoulli draws from that key (the same stream, made again)."""
    norms, codes = r_quantize_rows(vals, s, jax.random.PRNGKey(seed))
    u = jax.random.uniform(jax.random.PRNGKey(seed), vals.shape, jnp.float32)
    return norms, codes, u, renc.dequantize_rows(norms, codes, s)


def _ref_quantize(vals: np.ndarray, s: int, seed: int):
    """The reference's quantize_rows on ``vals`` with PRNGKey(seed)
    (compiled, as its sync runs it), the uniforms it drew (its
    bernoulli's) and its dequantized values."""
    out = _ref_quantize_jit(jnp.asarray(vals), s, seed)
    return tuple(np.array(x) for x in out)


def _port_quantize(vals: np.ndarray, s: int, u: np.ndarray):
    norms, codes = quantize_rows(torch.from_numpy(vals), s,
                                 torch.from_numpy(u))
    return norms.numpy(), codes.numpy()


def _dyadic(rows, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-64, 65, (rows, k)) / 8).astype(np.float32)


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------


DYADIC_S = (1, 15, QMAX)


@functools.lru_cache(maxsize=None)
def _ref_dyadic(k):
    """The reference's quantize (compiled once for the three s) of 64
    dyadic rows of k per s: {s: (vals, norms, codes, uniforms, deq)}."""
    vals = {s: _dyadic(64, k, seed=k + s) for s in DYADIC_S}
    seeds = {s: k * 7 + s for s in DYADIC_S}

    def f(vs, ss):
        return {s: _ref_quantize_jit.__wrapped__(vs[s], s, ss[s])
                for s in DYADIC_S}

    out = jax.jit(f)({s: jnp.asarray(v) for s, v in vals.items()}, seeds)
    return {s: (vals[s],) + tuple(np.array(x) for x in out[s])
            for s in DYADIC_S}


@pytest.mark.parametrize("s", DYADIC_S)
@pytest.mark.parametrize("k", [5, 10, 41, 64])
def test_quantize_rows_bitwise_on_dyadic_values(s, k):
    vals, r_norms, r_codes, u, r_deq = _ref_dyadic(k)[s]
    norms, codes = _port_quantize(vals, s, u)
    assert np.array_equal(_bits(norms), _bits(r_norms))
    np.testing.assert_array_equal(codes, r_codes)
    deq = enc.dequantize_rows(torch.from_numpy(norms),
                              torch.from_numpy(codes), s).numpy()
    assert np.array_equal(_bits(deq), _bits(r_deq))


@pytest.mark.parametrize("k", [5, 10, 26, 41, 64])
def test_quantize_rows_within_tolerance_on_random_values(k):
    """Norms within 2 ulp of the reference's (its sum order is XLA's);
    codes equal but where the reference's p_up is within 1e-5 of its
    uniform, and there one level apart with the same sign."""
    s = 15
    vals = np.random.default_rng(k).standard_normal((2000, k)).astype(
        np.float32)
    r_norms, r_codes, u, _ = _ref_quantize(vals, s, seed=k)
    norms, codes = _port_quantize(vals, s, u)
    ulp = np.spacing(r_norms)
    assert np.all(np.abs(norms - r_norms) <= 2 * ulp)
    r = np.asarray(jnp.abs(jnp.asarray(vals)) / jnp.asarray(r_norms)[:, None]
                   * s)
    p_up = np.clip(r - np.floor(r), 0.0, 1.0)
    near = np.abs(p_up - u) < 1e-5
    flip = codes != r_codes
    print(f"k = {k}: {int(flip.sum())} of {flip.size} codes one level from "
          f"the reference's, {int(near.sum())} near ties")
    assert not np.any(flip & ~near)
    np.testing.assert_array_equal(np.abs(codes[flip] - r_codes[flip]), 2)


@pytest.mark.parametrize("s", [1, 15, QMAX])
def test_signed_zero_tail_zero_rows_and_levels(s):
    """An exact -0.0 gives code 1, which dequantizes to -0.0; a zero row
    gives norm 0 and level 0; levels stay in [0, s] (an entry that is the
    whole norm is level s); all as the reference's."""
    vals = np.array([[1.0, -0.0, 0.0, -2.0],
                     [0.0, -0.0, 0.0, 0.0],
                     [0.0, 3.0, -0.0, 0.0],
                     [0.5, -0.25, 0.125, 0.75]], np.float32)
    r_norms, r_codes, u, _ = _ref_quantize(vals, s, seed=s)
    norms, codes = _port_quantize(vals, s, u)
    np.testing.assert_array_equal(codes, r_codes)
    assert np.array_equal(_bits(norms), _bits(r_norms))
    assert codes[0, 1] == 1 and codes[2, 2] == 1
    assert norms[1] == 0 and np.all(codes[1] >> 1 == 0)
    assert codes[2, 1] >> 1 == s  # the whole norm: r = s exactly
    assert (codes >> 1).min() >= 0 and (codes >> 1).max() <= s
    deq = enc.dequantize_rows(torch.from_numpy(norms),
                              torch.from_numpy(codes), s).numpy()
    assert deq[0, 1] == 0 and np.signbit(deq[0, 1])
    assert deq[0, 2] == 0 and not np.signbit(deq[0, 2])


def test_quantize_rows_unbiased_with_the_ports_noise():
    """E[deq] == vals within 5 sigma over 4000 draws of QuantNoise, sigma
    the Bernoulli's norm * sqrt(p (1 - p)) / (s sqrt(N)) per entry."""
    s, N = 3, 4000
    vals = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 10)).astype(np.float32))
    noise = QuantNoise(11, 0).uniforms(0, 1, 0, (N, 8, 10), "cpu")
    norms, codes = quantize_rows(vals.expand(N, 8, 10), s, noise)
    mean = enc.dequantize_rows(norms, codes, s).double().mean(0)
    norm = norms[0].double().unsqueeze(-1)
    r = vals.double().abs() / norm * s
    p = r - torch.floor(r)
    sigma = norm * torch.sqrt(p * (1 - p)) / (s * np.sqrt(N))
    assert torch.all((mean - vals.double()).abs() <= 5 * sigma + 1e-7)
    assert (codes >> 1).max() <= s


def test_quant_noise_is_keyed():
    """One key, one draw; each of (seed, step, bucket, level, index) moves
    it; a generator draws too."""
    n = QuantNoise(1, 2)
    a = n.uniforms(3, 1, 4, (5, 6), "cpu")
    assert torch.equal(a, QuantNoise(1, 2).uniforms(3, 1, 4, (5, 6), "cpu"))
    assert a.dtype == torch.float32 and 0 <= a.min() and a.max() < 1
    others = [QuantNoise(0, 2).uniforms(3, 1, 4, (5, 6), "cpu"),
              QuantNoise(1, 3).uniforms(3, 1, 4, (5, 6), "cpu"),
              n.uniforms(2, 1, 4, (5, 6), "cpu"),
              n.uniforms(3, 2, 4, (5, 6), "cpu"),
              n.uniforms(3, 1, 5, (5, 6), "cpu")]
    assert all(not torch.equal(a, o) for o in others)
    g = torch.Generator().manual_seed(0)
    norms, codes = quantize_rows(torch.ones(2, 3), 4, g)
    assert codes.shape == (2, 3) and norms.shape == (2,)


# ---------------------------------------------------------------------------
# QSGD as an optimizer (tests/test_optim.py's checks)
# ---------------------------------------------------------------------------


def _opt_quadratic(tx, steps=300, d=10):
    target = torch.linspace(-1, 1, d)
    w = torch.zeros(d)
    s = tx.init(w)
    for _ in range(steps):
        u, s = tx.update(w - target, s, params=w)
        w = apply_updates(w, u)
    return float(torch.linalg.norm(w - target))


def test_qsgd_converges_statistically():
    assert _opt_quadratic(qsgd(0.05, s=16), steps=800) < 0.05


def test_qsgd_quantize_unbiased():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(500)
                         .astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    est = torch.stack([qsgd_quantize(g, 8, gen) for _ in range(500)]).mean(0)
    assert float(torch.linalg.norm(est - g) / torch.linalg.norm(g)) < 0.15


def test_qsgd_quantize_levels():
    g = torch.tensor([0.3, -0.7, 0.1])
    q = qsgd_quantize(g, 4, torch.Generator().manual_seed(0))
    levels = q.abs().numpy() / float(torch.linalg.norm(g)) * 4
    np.testing.assert_allclose(levels, np.round(levels), atol=1e-5)


# ---------------------------------------------------------------------------
# the quantized wire tier: bytes against the reference's
# ---------------------------------------------------------------------------


def _codes(rows, k, s, seed):
    """Valid codes (a level in [0, s] and a sign bit) and positive float32
    norms of a (rows, k) selection."""
    rng = np.random.default_rng(seed)
    codes = (rng.integers(0, s + 1, (rows, k)) << 1) | rng.integers(
        0, 2, (rows, k))
    norms = np.abs(rng.standard_normal(rows)).astype(np.float32)
    return norms, codes.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ref_codec(spec):
    """The reference's encode (at live_n) and its readers of the buffer,
    compiled for one spec."""
    def f(codes, idx, norms, live):
        buf = renc.encode(spec, codes, idx, live_n=live, norms=norms)
        return (buf,) + renc.decode(spec, buf) + renc.decode_quant(spec, buf)
    return jax.jit(f)


def _port_codec(spec, codes, idx, norms, live):
    buf = enc.encode(spec, torch.from_numpy(codes), torch.from_numpy(idx),
                     live_n=live, norms=torch.from_numpy(norms))
    return (buf,) + enc.decode(spec, buf) + enc.decode_quant(
        spec, buf.view(torch.int32))


def _same_words(port_buf: torch.Tensor, ref_buf) -> bool:
    return np.array_equal(port_buf.view(torch.int32).numpy(),
                          np.asarray(ref_buf).view(np.int32))


@pytest.mark.parametrize("rows,cols,k,s", [
    (3, 100, 33, 1), (5, 1024, 10, 15), (2, 17, 17, 255), (4, 700, 233, QMAX),
    (1, 1, 1, 3)])
def test_quant_wire_bytes_match_reference(rows, cols, k, s):
    """encode, decode and decode_quant on the same codes, indices and
    norms: the reference's bytes word for word, its dequantized values bit
    for bit, its codes, norms and indices; the accounted bytes the
    realized buffer's."""
    norms, codes = _codes(rows, k, s, seed=rows * cols + s)
    idx = np.random.default_rng(1).integers(0, cols, (rows, k)).astype(
        np.int32)
    live = min(k, 1 + rows % 3)
    spec = enc.WireSpec(rows, cols, k, "float32", quant=s)
    rspec = renc.WireSpec(rows, cols, k, "float32", quant=s)
    ours = _port_codec(spec, codes, idx, norms, live)
    ref = _ref_codec(rspec)(jnp.asarray(codes), jnp.asarray(idx),
                            jnp.asarray(norms), live)
    assert _same_words(ours[0], ref[0])
    assert spec.nbytes == rspec.nbytes == 4 * ours[0].numel() == \
        enc.message_nbytes(rows, cols, k, "float32", "packed", quant=s)
    assert enc.WireSpec.from_header(ours[0]) == spec
    assert np.array_equal(_bits(ours[1].numpy()), _bits(ref[1]))
    assert np.array_equal(_bits(ours[3].numpy()), _bits(norms))
    for a, b in zip(ours[2:], ref[2:]):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32))
    np.testing.assert_array_equal(ours[4].numpy(), codes)


@settings(max_examples=40, deadline=None)
@given(rows=st.integers(min_value=1, max_value=7),
       cols=st.sampled_from([1024, 17, 1, 100, 3, 2, 1000, 700]),
       s=st.sampled_from([1, 3, 15, 255, QMAX]))
def test_quant_roundtrip_property(rows, cols, s):
    """decode(encode(codes, idx, norms)) is dequantize_rows(norms, codes,
    s) bit for bit, the indices exactly, and the buffer's bytes the
    accounted ones (tests/test_quant_wire.py's property)."""
    k = max(1, cols // 3)
    norms, codes = _codes(rows, k, s, seed=rows * cols + s)
    idx = np.random.default_rng(2).integers(0, cols, (rows, k)).astype(
        np.int32)
    spec = enc.WireSpec(rows, cols, k, "float32", quant=s)
    buf, vals, got_idx, n3, c3, i3 = _port_codec(spec, codes, idx, norms, 0)
    assert 4 * buf.numel() == enc.message_nbytes(rows, cols, k, "float32",
                                                 "packed", quant=s)
    want = enc.dequantize_rows(torch.from_numpy(norms),
                               torch.from_numpy(codes), s)
    assert torch.equal(vals.view(torch.int32), want.view(torch.int32))
    np.testing.assert_array_equal(got_idx.numpy(), idx)
    np.testing.assert_array_equal(c3.numpy(), codes)
    np.testing.assert_array_equal(i3.numpy(), idx)
    assert torch.equal(n3.view(torch.int32),
                       torch.from_numpy(norms).view(torch.int32))


def test_quant_repack_repad_match_reference():
    """A k-padded quantized message (live pairs, then the (code 1, 0)
    tail) compacts to the reference's compacted buffer (its repack: the
    live slots re-encoded at k = live_n) word for word, and re-expands to
    the padded buffer bit for bit."""
    rows, cols, k_pad, live, s = 3, 257, 24, 5, 15
    norms, codes = _codes(rows, k_pad, s, seed=9)
    codes[:, live:] = 1
    idx = np.zeros((rows, k_pad), np.int32)
    idx[:, :live] = np.random.default_rng(2).integers(0, cols, (rows, live))
    spec = enc.WireSpec(rows, cols, k_pad, "float32", quant=s)
    buf = enc.encode(spec, torch.from_numpy(codes), torch.from_numpy(idx),
                     live_n=live, norms=torch.from_numpy(norms))
    small_spec, small = enc.repack(spec, buf)
    r_small_spec = renc.repack_spec(renc.WireSpec(rows, cols, k_pad,
                                                  "float32", quant=s), live)
    r_small = _ref_codec(r_small_spec)(
        jnp.asarray(codes[:, :live]), jnp.asarray(idx[:, :live]),
        jnp.asarray(norms), live)[0]
    assert (small_spec.k, small_spec.quant) == (r_small_spec.k, s) == (live,
                                                                        s)
    assert _same_words(small, r_small)
    assert 4 * small.numel() == enc.message_nbytes(rows, cols, live,
                                                   "float32", "packed",
                                                   quant=s)
    assert torch.equal(enc.repad(spec, small_spec, small), buf)
    assert enc.live_n_of(enc.repad(spec, small_spec, small)) == live


def test_quant_spec_checks_match_reference():
    """The tier's refusals, message for message: a dense message, bf16
    values, s out of [1, _QUANT_MAX], another value dtype; decode_quant
    of an unquantized spec."""
    bad = [dict(rows=2, cols=8, k=2, value_dtype="bfloat16", quant=15),
           dict(rows=2, cols=8, k=2, kind="dense", quant=15),
           dict(rows=2, cols=8, k=2, quant=0),
           dict(rows=2, cols=8, k=2, quant=QMAX + 1)]
    for kw in bad:
        with pytest.raises(ValueError) as ours:
            enc.WireSpec(**kw)
        with pytest.raises(ValueError) as ref:
            renc.WireSpec(**kw)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="no alternate value dtype"):
        enc.WireSpec(2, 8, 2, quant=3).with_value_dtype("bfloat16")
    assert enc.WireSpec(2, 8, 2).with_value_dtype("bfloat16").value_words == 1
    with pytest.raises(ValueError, match="wants a quantized"):
        enc.decode_quant(enc.WireSpec(2, 8, 2), torch.zeros(12,
                                                           dtype=torch.int32))
    with pytest.raises(ValueError, match="needs row norms"):
        enc.encode(enc.WireSpec(1, 8, 2, quant=3), torch.ones(1, 2),
                   torch.zeros(1, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="only apply to the quantized"):
        enc.encode(enc.WireSpec(1, 8, 2), torch.ones(1, 2),
                   torch.zeros(1, 2, dtype=torch.int32), norms=torch.ones(1))


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [None, 1, 3, 15, 255, QMAX])
def test_message_bytes_grid_matches_reference(s):
    for rows in (1, 7, 1000):
        for cols in (1, 2, 17, 100, 1024, 4096):
            for k in sorted({1, max(1, cols // 100), max(1, cols // 3),
                             cols}):
                for wire in ("packed", "unpacked"):
                    assert enc.message_nbytes(rows, cols, k, "float32", wire,
                                              quant=s) == \
                        renc.message_nbytes(rows, cols, k, "float32", wire,
                                            quant=s)
                if s is not None:
                    a = enc.WireSpec(rows, cols, k, quant=s)
                    b = renc.WireSpec(rows, cols, k, quant=s)
                    assert (a.code_words, a.value_words, a.value_bits,
                            a.words) == (b.code_words, b.value_words,
                                         b.value_bits, b.words)


def _tree_shapes():
    return {"w1": (128, 256), "w2": (3, 64, 100), "b": (64,),
            "blk": {"z": (90, 200), "v": (60, 300)}}


def _plans(cols=512):
    shapes = _tree_shapes()
    port = bk.make_plan(jax.tree.map(
        lambda s: torch.empty(s, device="meta"), shapes,
        is_leaf=lambda x: isinstance(x, tuple)), cols=cols)
    ref = rbk.make_plan(jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple)), cols=cols)
    return port, ref


@pytest.mark.parametrize("strategy", ["sparse_allgather", "hierarchical"])
@pytest.mark.parametrize("quant", [None, 1, 15])
def test_bucket_and_amortized_bytes_match_reference(strategy, quant):
    plan, rplan = _plans()
    for wire in ("packed", "unpacked"):
        for H in (1, 2, 3, 4, 8):
            kw = dict(strategy=strategy, ratio=0.02, bucketed=True,
                      bucket_cols=512, local_steps=H)
            pod = dict(axis="pod", ratio=0.01)
            ours = SyncConfig(**kw, pod=PodConfig(**pod),
                              wire=WireConfig(wire=wire, quant=quant))
            ref = RSyncConfig(**kw, pod=RPodConfig(**pod),
                              wire=RWireConfig(wire=wire, quant=quant))
            for lv in ({}, dict(by_level=True, n_data=2)):
                assert bucketed_message_bytes(ours, plan, **lv) == \
                    r_bucket_bytes(ref, rplan, **lv)
                got = amortized_bytes_per_step(ours, plan, **lv)
                assert got == r_amortized(ref, rplan, **lv)
                full = bucketed_message_bytes(ours, plan, **lv)
                if lv:
                    assert got == {k: v / H for k, v in full.items()}
                else:
                    assert got == full / H


def test_qwen3_4b_qsparse_bytes():
    """qwen3-4b at full width, 4 layers, ratio 0.01 (k = 10 of its
    (1154560, 1024) bucket): the topk preset ships 64,751,648 B a step,
    qsparse_local 32,423,968 B a sync, 8,105,992 B a step amortized at
    H = 4; the reference's accounting gives the same."""
    plan = bk.make_plan(build_model(get_config("qwen3-4b").replace(
        n_layers=4)).param_shapes(), cols=1024)
    rplan = rbk.make_plan(ref_build_model(ref_get_config("qwen3-4b").replace(
        n_layers=4)).param_shapes(), cols=1024)
    assert [s.shape for s in plan.buckets] == [s.shape for s in rplan.buckets]
    assert (1154560, 1024) in [s.shape for s in plan.buckets]
    q = SyncConfig.preset("qsparse_local", ratio=0.01)
    rq = RSyncConfig.preset("qsparse_local", ratio=0.01)
    topk = SyncConfig.preset("topk", ratio=0.01)
    assert bucketed_message_bytes(topk, plan) == 64_751_648
    assert bucketed_message_bytes(q, plan) == 32_423_968 == \
        r_bucket_bytes(rq, rplan)
    assert amortized_bytes_per_step(q, plan) == 8_105_992 == \
        r_amortized(rq, rplan)


# ---------------------------------------------------------------------------
# the grouped SyncConfig and its validation (tests/test_sync_api.py's)
# ---------------------------------------------------------------------------

ILLEGAL = {
    "quant without buckets": dict(wire=dict(quant=15)),
    "quant on the dense strategy": dict(strategy="dense", bucketed=True,
                                        wire=dict(quant=15)),
    "quant at bf16 wire values": dict(bucketed=True, wire=dict(
        value_dtype="bfloat16", quant=15)),
    "quant below one level": dict(bucketed=True, wire=dict(quant=0)),
    "local steps on the per-leaf path": dict(local_steps=2),
    "local steps below 1": dict(local_steps=0),
}


@pytest.mark.parametrize("mix", list(ILLEGAL))
def test_validation_errors_match_reference(mix):
    kw = dict(ILLEGAL[mix])
    wire = kw.pop("wire", {})
    with pytest.raises(ValueError) as ours:
        SyncConfig(**kw, wire=WireConfig(**wire)).validate()
    with pytest.raises(ValueError) as ref:
        RSyncConfig(**kw, wire=RWireConfig(**wire)).validate()
    assert str(ours.value) == str(ref.value)


def test_grouped_construction_and_flat_reads():
    with _no_deprecation():
        cfg = SyncConfig(
            strategy="hierarchical", ratio=0.01, bucketed=True,
            local_steps=4,
            pod=PodConfig(ratio=0.2, ratios=[0.1, 0.3], mass_target=0.8,
                          dynamic=True, k_max_ratio=0.5, axis="pod"),
            wire=WireConfig(wire="packed", quant=15),
            transport=TransportConfig(repack=True, byte_budget=4096,
                                      overlap=True))
    assert (cfg.pod_ratio, cfg.pod_ratios, cfg.pod_mass_target,
            cfg.pod_dynamic, cfg.pod_k_max_ratio, cfg.pod_axis) == (
        0.2, (0.1, 0.3), 0.8, True, 0.5, "pod")
    assert (cfg.wire, cfg.value_dtype, cfg.quant) == ("packed", "float32", 15)
    assert (cfg.repack, cfg.byte_budget, cfg.overlap) == (True, 4096, True)
    assert cfg.local_steps == 4 and cfg.validate() is cfg


def test_flat_keywords_warn_and_land_in_groups():
    with pytest.warns(DeprecationWarning, match="grouped"):
        cfg = SyncConfig(ratio=0.01, bucketed=True, wire="packed",
                         pod_ratio=0.1, quant=7, overlap=False)
    assert cfg.wire_cfg == WireConfig(wire="packed", quant=7)
    assert cfg.pod.ratio == 0.1 and cfg.transport.overlap is False
    with pytest.warns(DeprecationWarning):
        assert dataclasses.replace(cfg, quant=3).quant == 3
    with pytest.raises(TypeError):
        SyncConfig(ratio=0.01, not_a_field=3)
    with pytest.raises(TypeError):
        SyncConfig(wire=WireConfig(), wire_cfg=WireConfig())


def test_replace_and_with_helpers_are_warning_free():
    cfg = SyncConfig(strategy="hierarchical", bucketed=True,
                     pod=PodConfig(ratio=0.1, axis="pod"),
                     wire=WireConfig(wire="packed"))
    with _no_deprecation():
        cfg2 = dataclasses.replace(cfg, ratio=0.5)
        cfg3 = cfg.with_pod(dynamic=True).with_wire(quant=15) \
            .with_transport(repack=True)
    assert cfg2.ratio == 0.5 and (cfg2.pod, cfg2.wire_cfg, cfg2.transport) \
        == (cfg.pod, cfg.wire_cfg, cfg.transport)
    assert cfg3.pod_dynamic and cfg3.quant == 15 and cfg3.repack
    assert cfg3.pod_axis == "pod" and cfg3.wire == "packed"


def test_presets_match_reference():
    """Every preset of the reference's, with its flat overrides warning
    free: the same fields."""
    def fields(c):
        return (c.strategy, c.ratio, c.bucketed, c.local_steps,
                dataclasses.astuple(c.pod), dataclasses.astuple(c.wire_cfg),
                dataclasses.astuple(c.transport))

    for name in ("dense", "topk", "qsparse_local", "pod_budgeted"):
        with _no_deprecation():
            ours = SyncConfig.preset(name, ratio=0.05)
        assert fields(ours) == fields(RSyncConfig.preset(name, ratio=0.05))
    with _no_deprecation():
        q = SyncConfig.preset("qsparse_local", quant=7, local_steps=2)
    assert (q.quant, q.local_steps, q.wire, q.bucketed) == (7, 2, "packed",
                                                            True)
    q.validate()
    with pytest.raises(ValueError, match="unknown SyncConfig preset"):
        SyncConfig.preset("nope")
