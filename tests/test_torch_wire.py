"""The port's packed wire codec (``repro_torch.core.encoding``) against the
reference's (``repro.core.encoding``): for the same pairs the encoded
bytes are equal bit for bit, ``decode(encode)`` round-trips bit for bit
(indices, and values in the wire dtype), and the accounting agrees.
Inputs are made with numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as renc
from repro_torch.core import encoding as enc

# (rows, cols, k, value dtype): odd k (bf16 pads a half word), k = cols,
# cols not a power of two, one row, fields that straddle words
CASES = [
    (5, 1024, 20, "float32"), (5, 1024, 20, "bfloat16"),
    (3, 1000, 7, "bfloat16"), (3, 1000, 7, "float32"),
    (1, 37, 37, "float32"), (1, 37, 37, "bfloat16"),
    (4, 131075, 33, "bfloat16"), (2, 2, 1, "float32"),
    (6, 2560, 51, "float32"),
]


def _pairs(rows, cols, k, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((rows, k)).astype(np.float32)
    vals[0, 0] = -0.0
    idx = np.stack([rng.choice(cols, k, replace=False)
                    for _ in range(rows)]).astype(np.int32)
    return vals, idx


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


@pytest.mark.parametrize("rows,cols,k,dt", CASES)
def test_encode_bytes_equal_the_reference(rows, cols, k, dt):
    vals, idx = _pairs(rows, cols, k)
    spec, rspec = enc.WireSpec(rows, cols, k, dt), renc.WireSpec(
        rows, cols, k, dt)
    buf = enc.encode(spec, torch.from_numpy(vals), torch.from_numpy(idx))
    want = np.asarray(renc.encode(rspec, jnp.asarray(vals).astype(dt),
                                  jnp.asarray(idx)))
    assert buf.dtype == torch.uint32 and buf.shape == (rspec.words,)
    np.testing.assert_array_equal(buf.numpy().view(np.uint8),
                                  want.view(np.uint8))
    assert spec.words == rspec.words and spec.nbytes == rspec.nbytes
    assert spec.nbits == 8 * spec.nbytes == 8 * want.nbytes
    # the header words, word for word
    np.testing.assert_array_equal(spec.header().numpy(),
                                  np.asarray(rspec.header()))
    assert enc.WireSpec.from_header(buf) == spec
    assert enc.live_n_of(buf) is None and renc.live_n_of(want) is None


@pytest.mark.parametrize("rows,cols,k,dt", CASES)
def test_decode_round_trips_bit_for_bit(rows, cols, k, dt):
    vals, idx = _pairs(rows, cols, k, seed=1)
    spec = enc.WireSpec(rows, cols, k, dt)
    v = torch.from_numpy(vals)
    got_v, got_i = enc.decode(spec, enc.encode(spec, v, torch.from_numpy(idx)))
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), idx)
    want_v = v.to(getattr(torch, dt))
    assert got_v.dtype == want_v.dtype
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
    # the reference decodes the port's bytes to the same pairs
    rv, ri = renc.decode(renc.WireSpec(rows, cols, k, dt),
                         jnp.asarray(enc.encode(spec, v, torch.from_numpy(
                             idx)).numpy()))
    np.testing.assert_array_equal(np.asarray(ri), idx)
    np.testing.assert_array_equal(
        np.asarray(rv).view(np.int16 if dt == "bfloat16" else np.int32),
        _bits(got_v))
    # and the int32 view a collective carries decodes the same
    iv, ii = enc.decode(spec, enc.encode(spec, v, torch.from_numpy(idx))
                        .view(torch.int32))
    assert torch.equal(ii, got_i)
    np.testing.assert_array_equal(_bits(iv), _bits(got_v))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_dense_messages_equal_the_reference(dt):
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((3, 17)).astype(np.float32)
    spec, rspec = (enc.WireSpec(3, 17, 1, dt, kind="dense"),
                   renc.WireSpec(3, 17, 1, dt, kind="dense"))
    buf = enc.encode(spec, torch.from_numpy(vals))
    want = np.asarray(renc.encode(rspec, jnp.asarray(vals).astype(dt)))
    np.testing.assert_array_equal(buf.numpy(), want)
    got_v, got_i = enc.decode(spec, buf)
    assert got_i is None and got_v.shape == (3, 17)


@pytest.mark.parametrize("live_n", [0, 3, 20])
def test_live_n_header_word_equals_the_reference(live_n):
    vals, idx = _pairs(5, 1024, 20, seed=3)
    spec, rspec = enc.WireSpec(5, 1024, 20), renc.WireSpec(5, 1024, 20)
    buf = enc.encode(spec, torch.from_numpy(vals), torch.from_numpy(idx),
                     live_n=live_n)
    want = np.asarray(renc.encode(rspec, jnp.asarray(vals), jnp.asarray(idx),
                                  live_n=live_n))
    np.testing.assert_array_equal(buf.numpy(), want)
    assert enc.live_n_of(buf) == renc.live_n_of(want) == (live_n or None)


def test_corrupt_live_n_raises():
    vals, idx = _pairs(2, 64, 4, seed=4)
    spec = enc.WireSpec(2, 64, 4)
    buf = enc.encode(spec, torch.from_numpy(vals), torch.from_numpy(idx),
                     live_n=9)
    with pytest.raises(ValueError, match="live_n=9"):
        enc.decode(spec, buf)
    with pytest.raises(ValueError, match="live_n=9"):
        enc.live_n_of(buf)
    bad = buf.clone()
    bad.view(torch.int32)[0] = 7
    with pytest.raises(ValueError, match="magic"):
        enc.WireSpec.from_header(bad)


def test_accounting_equals_the_reference():
    for d, k in ((1000, 10), (2**20, 1000), (7, 7)):
        assert enc.index_bits(d) == renc.index_bits(d)
        assert enc.dense_bits(d) == renc.dense_bits(d)
        assert enc.sparse_bits(d, k, 16) == renc.sparse_bits(d, k, 16)
        assert enc.reduction_factor(d, k) == renc.reduction_factor(d, k)
        assert enc.qsgd_bits(d, 15) == renc.qsgd_bits(d, 15)
        for dt in ("float32", "bfloat16"):
            assert enc.value_bits(dt) == renc.value_bits(dt)
            assert enc.memsgd_message_bits(d, k, dt) == \
                renc.memsgd_message_bits(d, k, dt)
    for s in (1, 3, 15):
        assert enc.quant_code_bits(s) == renc.quant_code_bits(s)
    for rows, cols, k, dt in CASES:
        for wire in ("packed", "unpacked"):
            assert enc.message_nbytes(rows, cols, k, dt, wire) == \
                renc.message_nbytes(rows, cols, k, dt, wire)


def test_the_quantized_tier_raises_by_name():
    """The quantized tier is ported: it refuses what the reference's
    refuses, by name (bf16 wire values, a dense message), and accounts
    the rest as the reference's."""
    with pytest.raises(ValueError, match="quantized"):
        enc.WireSpec(4, 64, 8, "bfloat16", quant=15)
    with pytest.raises(ValueError, match="quantized"):
        enc.WireSpec(4, 64, 8, kind="dense", quant=15)
    assert enc.message_nbytes(4, 64, 8, wire="packed", quant=15) == \
        renc.message_nbytes(4, 64, 8, wire="packed", quant=15)


def test_bad_shapes_raise():
    spec = enc.WireSpec(2, 64, 4)
    with pytest.raises(ValueError, match="values shape"):
        enc.encode(spec, torch.zeros(2, 5), torch.zeros(2, 5, dtype=torch.int32))
    with pytest.raises(ValueError, match="needs indices"):
        enc.encode(spec, torch.zeros(2, 4))
    with pytest.raises(ValueError, match="buffer shape"):
        enc.decode(spec, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="out of range"):
        enc.WireSpec(2, 64, 65)
