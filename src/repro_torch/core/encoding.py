"""Packed sparse wire codec and communication accounting (port of
``repro.core.encoding``, its codec half).

1. **Accounting** (python ints/floats): bits per step per scheme, the
   paper's formulas (§4.2, §4.3, Appendix B), and ``message_nbytes``,
   the exact bytes one sparse (rows, cols, k) message puts on the wire.

2. **Codec** (``WireSpec`` + ``encode``/``decode``): k (value, index)
   pairs per row of an (rows, cols) buffer, bit-packed into one flat
   uint32 buffer::

       [ header : HEADER_WORDS words ]
       [ values : rows * value_words words  (f32 bitcast | bf16 pairs) ]
       [ packed_indices : rows * index_words words
                          (row-local indices, ceil(log2 cols) bits each,
                           LSB-first within each 32-bit word) ]

   Header words: [magic, version, rows, cols, n_sel, dtype, kind,
   live_n]; ``live_n`` (word ``LIVE_N_WORD``) is the one dynamic field,
   0 meaning "all n_sel slots live". The bytes equal the reference's
   ``encode`` output for the same pairs, and ``decode(encode(v, i))``
   returns ``i`` and ``v`` (in the wire value dtype) bit for bit.

Torch has no uint32 shifts or gathers on the CPU, so the fields are
packed in int64 and the buffer is viewed as uint32 only at its edge;
collectives take its int32 view (``buf.view(torch.int32)``).

3. **Repack** (``repack_spec``/``repack``/``repad``): the codec half of
   the header-aware transport. A k-padded message (the runtime-k pod
   sync) compacts to its live_n slots per row and re-expands to the
   padded buffer bit for bit; ``message_nbytes(rows, cols, live_n)`` is
   the compacted size.

4. **Quantized value tier** (``WireSpec(quant=s)``, sparse and float32
   only): the value section of a row carries QSGD's s-level codes
   (Qsparse-local-SGD's Q step) instead of full-width values::

       [ row_norm : 1 word (f32 bitcast) ]
       [ codes    : ceil(n_sel * quant_bits / 32) words ]

   each code ``(level << 1) | sign_bit`` at ``quant_bits = 1 +
   ceil(log2(s+1))`` bits, LSB-first; s rides in the header's dtype word
   (``code | s << 8``). ``decode`` returns the dequantized float32 values
   (``dequantize_rows``, the one formula the sender and every receiver
   apply), ``decode_quant`` the raw (norms, codes). The sign is stored
   apart from the level, so a (-0.0, 0) padded slot (code 1) decodes to
   -0.0. Quantizing is ``optim.qsgd.quantize_rows``.

5. **Transcode** (``transcode``): a message's value section re-encoded
   in another value dtype, its index section untouched (the fan-out
   hub's bf16 tier).

6. **Snapshot records** (``SnapshotRecord``, ``snapshot_encode``,
   ``snapshot_decode``): one (rows, cols) buffer serialized through the
   codec: the entries that differ from a base buffer (or from zero),
   exactly, or a lossy per-row top-k cap, or a dense fallback (wire
   checkpoints and the hub's snapshot resync).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

MAGIC = 0x53505257  # "SPRW"
VERSION = 1
HEADER_WORDS = 8
# header slot carrying the runtime live entry count of a k-padded message
# (0 = every n_sel slot is live)
LIVE_N_WORD = 7
_DTYPE_CODES = {"float32": 0, "bfloat16": 1}
_DTYPE_NAMES = {v: k for k, v in _DTYPE_CODES.items()}
_KIND_CODES = {"sparse": 0, "dense": 1}
_KIND_NAMES = {v: k for k, v in _KIND_CODES.items()}
# quantization levels ride in the high bits of the header dtype word
# (code | s << 8); capped so a code (sign bit + level) fits 16 bits
_QUANT_MAX = (1 << 15) - 1
_WORD = 1 << 32


# ---------------------------------------------------------------------------
# accounting (paper Appendix B + exact packed-wire byte counts)
# ---------------------------------------------------------------------------


def dense_bits(d: int, bits_per_value: int = 32) -> float:
    return float(bits_per_value * d)


def index_bits(d: int) -> int:
    """Bits to address one of d positions (>= 1)."""
    return max(1, math.ceil(math.log2(max(2, d))))


def value_bits(value_dtype: str) -> int:
    """Wire bits per value for a sync value dtype (f32: 32, bf16: 16)."""
    return getattr(torch, value_dtype).itemsize * 8


def sparse_bits(d: int, k: float, bits_per_value: int = 32) -> float:
    """k (value, index) pairs against a d-long address space."""
    return k * (bits_per_value + index_bits(d))


def qsgd_bits(d: int, s: int) -> float:
    """Paper Appendix B formula for s quantization levels."""
    naive = (math.log2(s) + 1.0) * d
    elias = 3.0 * s * (s + math.sqrt(d)) + 32.0
    return min(naive, elias)


def quant_code_bits(s: int) -> int:
    """Wire bits per quantized value: a sign bit plus a level in [0, s],
    ``1 + ceil(log2(s+1))`` (s = 1: 2 bits, s = 15: 5)."""
    if s < 1:
        raise ValueError(f"quantization levels must be >= 1, got {s}")
    return 1 + max(1, math.ceil(math.log2(s + 1)))


def memsgd_message_bits(d: int, k: int, value_dtype="float32") -> float:
    """Bits per worker per step for the distributed sparse all-gather."""
    return sparse_bits(d, k, value_bits(value_dtype))


def reduction_factor(d: int, k: float, bits_per_value: int = 32) -> float:
    """Communication reduction vs dense SGD (the paper's d/k gain)."""
    return dense_bits(d, bits_per_value) / sparse_bits(d, k, bits_per_value)


def message_nbytes(rows: int, cols: int, k: int, value_dtype="float32",
                   wire: str = "unpacked", quant: Optional[int] = None) -> int:
    """Exact bytes one sparse (rows, cols, k) message puts on the wire: the
    packed ``WireSpec`` buffer's size, or the unpacked (value_dtype values,
    int32 indices) pair arrays. ``quant=s`` accounts the quantized tier on
    the packed wire; the unpacked wire ships the dequantized values at
    full width."""
    if wire == "packed":
        return WireSpec(rows, cols, k, value_dtype, quant=quant).nbytes
    return rows * k * (value_bits(value_dtype) // 8 + 4)


# ---------------------------------------------------------------------------
# packed wire codec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Static layout of one packed wire message.

    ``kind="sparse"``: k (value, row-local index) pairs per row.
    ``kind="dense"``: all cols values per row, no index section; ``k`` is
    ignored. ``quant=s``: the value section carries s-level codes and one
    float32 row norm (sparse, float32 only)."""

    rows: int
    cols: int
    k: int
    value_dtype: str = "float32"
    kind: str = "sparse"
    quant: Optional[int] = None

    def __post_init__(self):
        if self.value_dtype not in _DTYPE_CODES:
            raise ValueError(
                f"unsupported wire value dtype {self.value_dtype!r}")
        if self.kind not in _KIND_CODES:
            raise ValueError(f"unknown wire kind {self.kind!r}")
        if self.kind == "sparse" and not 1 <= self.k <= self.cols:
            raise ValueError(f"k={self.k} out of range for cols={self.cols}")
        if self.quant is not None:
            if self.kind != "sparse":
                raise ValueError("quantized wire tier is sparse-only")
            if self.value_dtype != "float32":
                raise ValueError(
                    "quantized wire tier carries f32 row norms; "
                    f"value_dtype={self.value_dtype!r} is not composable")
            if not 1 <= self.quant <= _QUANT_MAX:
                raise ValueError(
                    f"quant={self.quant} out of range [1, {_QUANT_MAX}]")

    @property
    def n_sel(self) -> int:
        """Entries per row on the wire (k, or cols for dense messages)."""
        return self.cols if self.kind == "dense" else self.k

    @property
    def index_bits(self) -> int:
        return 0 if self.kind == "dense" else index_bits(self.cols)

    @property
    def value_bits(self) -> int:
        """Wire bits per value entry (code bits on the quantized tier)."""
        if self.quant is not None:
            return quant_code_bits(self.quant)
        return value_bits(self.value_dtype)

    @property
    def code_words(self) -> int:
        """uint32 words per row holding the packed quantized codes."""
        if self.quant is None:
            return 0
        return -(-(self.n_sel * self.value_bits) // 32)

    @property
    def value_words(self) -> int:
        """uint32 words per row for the value section (quantized tier: one
        f32 norm word and the packed codes)."""
        if self.quant is not None:
            return 1 + self.code_words
        return -(-(self.n_sel * self.value_bits) // 32)

    @property
    def index_words(self) -> int:
        """uint32 words per row for the packed index section."""
        return -(-(self.n_sel * self.index_bits) // 32)

    @property
    def words(self) -> int:
        return HEADER_WORDS + self.rows * (self.value_words + self.index_words)

    @property
    def nbytes(self) -> int:
        """Exact bytes of the encoded buffer."""
        return 4 * self.words

    @property
    def nbits(self) -> int:
        return 32 * self.words

    def with_value_dtype(self, value_dtype: str) -> "WireSpec":
        """The same layout with another wire value dtype (the index section
        and k unchanged); a quantized spec has none other."""
        if self.quant is not None:
            raise ValueError(
                "quantized wire messages have no alternate value dtype; "
                "dequantize and re-encode instead")
        return dataclasses.replace(self, value_dtype=value_dtype)

    def header(self, live_n: int = 0, device="cpu") -> torch.Tensor:
        """The HEADER_WORDS header words (uint32)."""
        dtype_word = _DTYPE_CODES[self.value_dtype] | ((self.quant or 0) << 8)
        return _as_words(torch.tensor(
            [MAGIC, VERSION, self.rows, self.cols, self.n_sel, dtype_word,
             _KIND_CODES[self.kind], int(live_n)], dtype=torch.int64,
            device=device))

    @classmethod
    def from_header(cls, buf) -> "WireSpec":
        """The spec of a received buffer, from its header words (a host
        read)."""
        h = _host_header(buf)
        if h[0] != MAGIC or h[1] != VERSION:
            raise ValueError(
                f"bad wire header magic/version {h[0]:#x}/{h[1]}")
        return cls(rows=h[2], cols=h[3], k=h[4],
                   value_dtype=_DTYPE_NAMES[h[5] & 0xFF],
                   kind=_KIND_NAMES[h[6]], quant=(h[5] >> 8) or None)


@functools.lru_cache(maxsize=64)
def _header_on(spec: WireSpec, live_n: int, device: torch.device
               ) -> torch.Tensor:
    """``spec``'s header on ``device``, made once: copying it there anew on
    every step would make the host wait for the card."""
    return spec.header(live_n, device)


def _as_words(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the same bits as uint32."""
    return torch.where(x >= (1 << 31), x - _WORD, x).to(
        torch.int32).view(torch.uint32)


def _as_int64(words: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32) words -> int64 values in [0, 2**32)."""
    if words.dtype == torch.uint32:
        words = words.view(torch.int32)
    return words.to(torch.int64) & (_WORD - 1)


def _host_header(buf) -> list:
    """The header words of a buffer as python ints (a host read)."""
    return [int(w) for w in _as_int64(torch.as_tensor(buf[:HEADER_WORDS])
                                      .cpu())]


def _field_layout(n: int, nbits: int, device):
    """For n fields of nbits bits, LSB-first: each field's word, its bit
    offset in that word, and whether it spills into the next word."""
    pos = torch.arange(n, dtype=torch.int64, device=device) * nbits
    word, off = pos // 32, pos % 32
    return word, off, off + nbits > 32


def _pack_bits(ints: torch.Tensor, nbits: int, words: int) -> torch.Tensor:
    """(R, n) non-negative ints (< 2**nbits) -> (R, words) uint32, an
    LSB-first bit stream of nbits-wide fields. Fields do not overlap, so
    adding their shifted parts into their words is the OR of them."""
    rows, n = ints.shape
    v = ints.to(torch.int64)
    word, off, spill = _field_layout(n, nbits, v.device)
    out = torch.zeros((rows, words + 1), dtype=torch.int64, device=v.device)
    out.scatter_add_(1, word.expand(rows, n),
                     (v << off) & (_WORD - 1))
    out.scatter_add_(1, (word + 1).expand(rows, n),
                     torch.where(spill, v >> (32 - off), 0))
    return _as_words(out[:, :words])


def _unpack_bits(packed: torch.Tensor, nbits: int, n: int) -> torch.Tensor:
    """(R, words) uint32 -> (R, n) int64, inverse of ``_pack_bits``."""
    p = _as_int64(packed)
    p = torch.cat([p, torch.zeros_like(p[:, :1])], dim=1)
    word, off, spill = _field_layout(n, nbits, p.device)
    lo = p[:, word] >> off
    # a field that does not spill shifts its next word by 32 - off <= 32
    # (< 2**64, discarded)
    hi = torch.where(spill, p[:, word + 1] << (32 - off).clamp(max=31), 0)
    return (lo | hi) & ((1 << nbits) - 1)


def _pack_values(spec: WireSpec, vals: torch.Tensor) -> torch.Tensor:
    """(R, n_sel) values -> (R, value_words) uint32 (bitcast; bf16 packs
    two values per word, low half first)."""
    v = vals.to(getattr(torch, spec.value_dtype))
    if spec.value_dtype == "float32":
        return v.contiguous().view(torch.int32).view(torch.uint32)
    u16 = v.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    pad = 2 * spec.value_words - spec.n_sel
    if pad:
        u16 = torch.nn.functional.pad(u16, (0, pad))
    pairs = u16.view(vals.shape[0], spec.value_words, 2)
    return _as_words(pairs[..., 0] | (pairs[..., 1] << 16))


def _unpack_values(spec: WireSpec, packed: torch.Tensor) -> torch.Tensor:
    """(R, value_words) uint32 -> (R, n_sel) values in the wire dtype."""
    if spec.value_dtype == "float32":
        return packed.view(torch.int32).view(torch.float32)
    w = _as_int64(packed)
    u16 = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(
        packed.shape[0], -1)[:, :spec.n_sel]
    u16 = torch.where(u16 >= (1 << 15), u16 - (1 << 16), u16)
    return u16.to(torch.int16).view(torch.bfloat16)


def dequantize_rows(norms: torch.Tensor, codes: torch.Tensor,
                    s: int) -> torch.Tensor:
    """The quantized tier's dequantization: codes ``(level << 1) | sign``
    -> ``+-norm * level / s`` per row, float32. The sender's own
    contribution and every receiver's decode apply this one formula, so
    the memory absorbs exactly the quantization error that ships. Code 1
    (level 0, sign 1) gives -0.0: the padded tail's identity survives.

    The product is the reference's as its sync computes it, compiled:
    XLA turns its ``norm * (level / s)`` into ``(norm * float32(1/s)) *
    level`` (the divide by the constant a multiply by its reciprocal,
    moved onto the norm), two float32 products, each rounded, on either
    device."""
    recip = float(np.float32(1.0 / s))
    scale = torch.mul(norms.to(torch.float32), recip).unsqueeze(-1)
    codes = codes.to(torch.int32)
    mag = torch.mul(scale, (codes >> 1).to(torch.float32))
    return torch.where((codes & 1).to(torch.bool), -mag, mag)


def _pack_values_quant(spec: WireSpec, codes: torch.Tensor,
                       norms: torch.Tensor) -> torch.Tensor:
    """(R, n_sel) codes and (R,) norms -> (R, value_words) uint32: the
    norm's float32 bits, then the LSB-first packed code stream."""
    nw = norms.to(torch.float32).contiguous().view(torch.int32).view(
        torch.uint32).unsqueeze(1)
    cw = _pack_bits(codes, spec.value_bits, spec.code_words)
    return torch.cat([nw, cw], dim=1)


def _unpack_values_quant(spec: WireSpec, packed: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``_pack_values_quant`` -> (norms (R,) float32, codes (R,
    n_sel) int32)."""
    norms = packed[:, 0].contiguous().view(torch.int32).view(torch.float32)
    codes = _unpack_bits(packed[:, 1:], spec.value_bits, spec.n_sel)
    return norms, codes.to(torch.int32)


def encode(spec: WireSpec, vals: torch.Tensor,
           idx: Optional[torch.Tensor] = None, live_n: Optional[int] = None,
           norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(values (rows, n_sel), indices (rows, k)) -> flat uint32 wire buffer
    of exactly ``spec.words`` words, on the values' device. For
    ``kind="dense"`` pass the (rows, cols) values only. ``live_n`` stamps
    the live entry count into header word ``LIVE_N_WORD``. On the
    quantized tier ``vals`` are the integer CODES and ``norms`` the (rows,)
    float32 row norms."""
    if tuple(vals.shape) != (spec.rows, spec.n_sel):
        raise ValueError(
            f"values shape {tuple(vals.shape)} != {(spec.rows, spec.n_sel)}")
    if spec.quant is not None:
        if norms is None:
            raise ValueError("quantized wire message needs row norms")
        if tuple(norms.shape) != (spec.rows,):
            raise ValueError(
                f"norms shape {tuple(norms.shape)} != {(spec.rows,)}")
        packed_vals = _pack_values_quant(spec, vals, norms)
    elif norms is not None:
        raise ValueError("norms only apply to the quantized tier")
    else:
        packed_vals = _pack_values(spec, vals)
    sections = [_header_on(spec, int(live_n or 0), vals.device),
                packed_vals.reshape(-1)]
    if spec.kind == "sparse":
        if idx is None:
            raise ValueError("sparse wire message needs indices")
        if tuple(idx.shape) != (spec.rows, spec.k):
            raise ValueError(
                f"index shape {tuple(idx.shape)} != {(spec.rows, spec.k)}")
        sections.append(
            _pack_bits(idx, spec.index_bits, spec.index_words).reshape(-1))
    return torch.cat(sections)


def decode(spec: WireSpec, buf: torch.Tensor
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Inverse of ``encode``: wire buffer (uint32 or its int32 view) ->
    (values (rows, n_sel) in the wire dtype, indices (rows, k) int32, or
    None for dense messages). The quantized tier's values come back
    dequantized (float32).

    A buffer on the CPU has its dynamic header word checked: a live_n
    above the n_sel laid-out slots raises. A buffer on the card skips the
    check, as the reference's traced decode does: reading a word back
    would make the host wait for the step."""
    if tuple(buf.shape) != (spec.words,):
        raise ValueError(f"buffer shape {tuple(buf.shape)} != {(spec.words,)}")
    buf = buf.view(torch.uint32) if buf.dtype == torch.int32 else buf
    if buf.device.type == "cpu":
        ln = _host_header(buf)[LIVE_N_WORD]
        if ln > spec.n_sel:
            raise ValueError(
                f"corrupt wire header: live_n={ln} exceeds the "
                f"{spec.n_sel} laid-out slots per row")
    off = HEADER_WORDS
    nv = spec.rows * spec.value_words
    packed_vals = buf[off:off + nv].reshape(spec.rows, spec.value_words)
    if spec.quant is not None:
        vals = dequantize_rows(*_unpack_values_quant(spec, packed_vals),
                               spec.quant)
    else:
        vals = _unpack_values(spec, packed_vals)
    if spec.kind == "dense":
        return vals, None
    return vals, _indices(spec, buf)


def _indices(spec: WireSpec, buf: torch.Tensor) -> torch.Tensor:
    """The (rows, k) int32 indices of a sparse buffer's index section."""
    off = HEADER_WORDS + spec.rows * spec.value_words
    ni = spec.rows * spec.index_words
    packed_idx = buf[off:off + ni].reshape(spec.rows, spec.index_words)
    return _unpack_bits(packed_idx, spec.index_bits, spec.k).to(torch.int32)


def decode_quant(spec: WireSpec, buf: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The quantized tier's raw reader: wire buffer -> (norms (rows,)
    float32, codes (rows, k) int32, indices (rows, k) int32), without
    dequantizing (the repack transport and the tests read the codes)."""
    if spec.quant is None:
        raise ValueError("decode_quant wants a quantized WireSpec")
    if tuple(buf.shape) != (spec.words,):
        raise ValueError(f"buffer shape {tuple(buf.shape)} != {(spec.words,)}")
    buf = buf.view(torch.uint32) if buf.dtype == torch.int32 else buf
    off = HEADER_WORDS
    nv = spec.rows * spec.value_words
    norms, codes = _unpack_values_quant(
        spec, buf[off:off + nv].reshape(spec.rows, spec.value_words))
    return norms, codes, _indices(spec, buf)


def live_n_of(buf) -> Optional[int]:
    """The live entry count of a received buffer (a host read), or None
    when word ``LIVE_N_WORD`` is 0 (every n_sel slot live). Raises when
    it exceeds the header's own n_sel."""
    h = _host_header(buf)
    n, n_sel = h[LIVE_N_WORD], h[4]
    if n > n_sel:
        raise ValueError(
            f"corrupt wire header: live_n={n} exceeds the {n_sel} "
            f"laid-out slots per row")
    return n or None


# ---------------------------------------------------------------------------
# repack transport (codec half): compact a k-padded message to its live k
# ---------------------------------------------------------------------------


def repack_spec(spec: WireSpec, live_n: int) -> WireSpec:
    """Layout of the compacted message a k-padded ``spec`` shrinks to at
    ``live_n`` live slots per row: the same (rows, cols, dtype) at ``k =
    max(1, live_n)`` (the codec ships at least one slot; a zero-live
    message carries one (-0.0, 0) no-op pair)."""
    if spec.kind != "sparse":
        raise ValueError("repack applies to sparse wire messages only")
    if not 0 <= live_n <= spec.n_sel:
        raise ValueError(
            f"live_n={live_n} out of range for n_sel={spec.n_sel}")
    return dataclasses.replace(spec, k=max(1, int(live_n)))


def repack(spec: WireSpec, buf: torch.Tensor, live_n: Optional[int] = None
           ) -> Tuple[WireSpec, torch.Tensor]:
    """Compact a k-padded message to its live payload before it crosses a
    slow link: -> ``(small_spec, small_buf)`` laid out at
    ``repack_spec(spec, live_n)``.

    ``live_n`` defaults to the buffer's own header word (a host read);
    a message with every slot live passes through unchanged. Lossless:
    selections are contract-ordered, so the first live_n slots of each
    row are the live pairs and the dropped tail is the (-0.0, 0)
    identity. The small header keeps the live count, so ``repad``
    restores the padded buffer bit for bit."""
    if spec.kind != "sparse":
        return spec, buf
    if live_n is None:
        live_n = live_n_of(buf)
        if live_n is None:
            return spec, buf
    live_n = int(live_n)
    if live_n >= spec.n_sel:
        return spec, buf
    small = repack_spec(spec, live_n)
    if spec.quant is not None:
        norms, codes, idx = decode_quant(spec, buf)
        return small, encode(small, codes[:, :small.k], idx[:, :small.k],
                             live_n=live_n, norms=norms)
    vals, idx = decode(spec, buf)
    return small, encode(small, vals[:, :small.k], idx[:, :small.k],
                         live_n=live_n)


def repad(spec: WireSpec, small_spec: WireSpec,
          small_buf: torch.Tensor) -> torch.Tensor:
    """Inverse of ``repack``: re-expand a compacted message to the padded
    ``spec`` layout, bit for bit the buffer ``repack`` was given: the tail
    slots refill with the (-0.0, 0) identity and the live count is carried
    over from the small header (a host read)."""
    if small_spec == spec:
        return small_buf
    if spec.kind != "sparse" or small_spec.kind != "sparse":
        raise ValueError("repad applies to sparse wire messages only")
    if (small_spec.rows, small_spec.cols, small_spec.value_dtype) != (
            spec.rows, spec.cols, spec.value_dtype):
        raise ValueError(
            f"repacked layout {small_spec} does not shrink {spec}")
    if small_spec.k > spec.n_sel:
        raise ValueError(
            f"repacked k={small_spec.k} exceeds padded n_sel={spec.n_sel}")
    if small_spec.quant != spec.quant:
        raise ValueError(f"repacked quant tier {small_spec.quant} does not "
                         f"match {spec.quant}")
    raw_live = _host_header(small_buf)[LIVE_N_WORD]
    pad = spec.n_sel - small_spec.k
    if spec.quant is not None:
        norms, codes, idx = decode_quant(small_spec, small_buf)
        # code 1 = (level 0, sign 1): dequantizes to the -0.0 identity
        codes = torch.cat([codes, torch.ones((spec.rows, pad),
                                             dtype=torch.int32,
                                             device=codes.device)], dim=1)
        idx = torch.cat([idx, torch.zeros((spec.rows, pad), dtype=torch.int32,
                                          device=idx.device)], dim=1)
        return encode(spec, codes, idx, live_n=raw_live, norms=norms)
    vals, idx = decode(small_spec, small_buf)
    vals = torch.cat([vals, torch.full((spec.rows, pad), -0.0,
                                       dtype=vals.dtype, device=vals.device)],
                     dim=1)
    idx = torch.cat([idx, torch.zeros((spec.rows, pad), dtype=torch.int32,
                                      device=idx.device)], dim=1)
    return encode(spec, vals, idx, live_n=raw_live)


def transcode(spec: WireSpec, buf: torch.Tensor,
              value_dtype: str = "bfloat16") -> torch.Tensor:
    """Re-encode a wire message's VALUE section in another dtype, the
    index section untouched: one float32 message, transcoded once, serves
    every bf16 replica of the fan-out hub. float32 -> bf16 rounds to
    nearest even (lossy); bf16 -> float32 is exact. The result is laid out
    at ``spec.with_value_dtype(value_dtype)`` (its live_n word 0)."""
    vals, idx = decode(spec, buf)
    return encode(spec.with_value_dtype(value_dtype), vals, idx)


# ---------------------------------------------------------------------------
# snapshot records (wire-compressed buffer dumps; checkpoint + fan-out resync)
# ---------------------------------------------------------------------------

# elements per row chunk of the snapshot's support scan: its int32
# cumulative counts and int64 scatter indices stay within ~0.5 GB
SNAPSHOT_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class SnapshotRecord:
    """One (rows, cols) buffer serialized through the packed wire codec.

    Three encodings, chosen by ``snapshot_encode``:

    * exact sparse: every entry differing from the reference (``base``
      buffer, or zero) is on the wire; decode reproduces the buffer BIT
      FOR BIT (parameter buckets, whose drift from the boot checkpoint
      has bounded support under sparse training).
    * lossy sparse: per-row top-k by magnitude (``k=`` cap); decode
      reproduces the selected entries bit for bit and zeros the rest.
      ``dropped_frac`` reports the discarded squared mass (the
      error-feedback memory).
    * dense fallback: when the sparse layout would not be smaller, the
      buffer ships as a ``kind="dense"`` message (exact in the wire
      dtype).
    """

    spec: WireSpec
    buf: torch.Tensor  # uint32 wire buffer of exactly spec.words words
    vs_base: bool  # decode overlays onto the base buffer (else zeros)
    exact: bool  # decode(..) reproduces the buffer bit for bit
    dense_nbytes: int  # what the dense f32-per-item dump would cost
    dropped_frac: float  # squared-mass fraction lost (0.0 when exact)

    @property
    def nbytes(self) -> int:
        """Exact bytes on the wire / in the checkpoint file."""
        return self.spec.nbytes


def _bitpattern(x: torch.Tensor) -> torch.Tensor:
    """Values -> their bit patterns (a signed integer view), so that the
    support mask sees every BITWISE difference: float != misses -0.0
    against +0.0, which would break an exact record's restore."""
    return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])


def _row_chunks(rows: int, cols: int):
    step = max(1, SNAPSHOT_CHUNK // max(cols, 1))
    return [(r, min(rows, r + step)) for r in range(0, rows, step)]


def _support_mask(buf: torch.Tensor, base: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    """Where ``buf``'s bits differ from ``base``'s (from zero's without a
    base: -0.0 counts as set)."""
    if base is None:
        return _bitpattern(buf) != 0
    return _bitpattern(buf) != _bitpattern(base)


def _snapshot_indices_exact(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Per row: the indices of the True entries ascending, then of the
    False entries ascending, the first k of them (int32): the reference's
    ``argsort(~mask, stable=True)[:, :k]``. All indices of a row are
    distinct, so a scatter of the buffer's own values at them is exact.

    No sort: an entry's slot is its rank among its row's set entries, or
    the row's count of set entries plus its rank among the unset ones,
    from one int32 running count; the entries at slot k or later all go
    to a discarded column k. Peak memory: 17 bytes an element of ``mask``
    (the int32 count and slot, the int64 scatter index) and the
    (rows, k + 1) output; ``snapshot_encode`` passes row chunks of at most
    ``SNAPSHOT_CHUNK`` elements."""
    rows, cols = mask.shape
    count = torch.cumsum(mask, dim=1, dtype=torch.int32)
    j = torch.arange(cols, dtype=torch.int32, device=mask.device)
    slot = torch.where(mask, count - 1, count[:, -1:] + j - count)
    del count
    out = torch.empty((rows, k + 1), dtype=torch.int32, device=mask.device)
    out.scatter_(1, slot.clamp_(max=k).to(torch.int64), j.expand(rows, cols))
    return out[:, :k].contiguous()


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """sum(x**2) in float32 terms, accumulated in float64 over row
    chunks (a device scalar)."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for r0, r1 in _row_chunks(*x.shape):
        total += torch.sum(torch.square(x[r0:r1].to(torch.float32)),
                           dtype=torch.float64)
    return total


def snapshot_encode(buf: torch.Tensor, base: Optional[torch.Tensor] = None,
                    *, k: Optional[int] = None,
                    value_dtype: Optional[str] = None) -> SnapshotRecord:
    """Serialize one 2D buffer through the packed codec.

    ``base``: encode only the entries whose bits differ from ``base``'s
    (exact delta against a reference; decode needs the same base). ``k``:
    a lossy per-row top-|.| cap (only without ``base``), selected by
    ``kernels.ops.row_topk`` (decreasing |v|, ties to the lowest index,
    the reference's ``jax.lax.top_k``). With neither, every nonzero is
    encoded exactly. Falls back to a dense message whenever sparse would
    not be smaller, so the record never costs more than a dense dump and
    one header. The support is scanned in row chunks (``SNAPSHOT_CHUNK``
    elements), so no full-buffer mask or index array is made."""
    from repro_torch.kernels.ops import row_topk

    if buf.dim() != 2:
        raise ValueError(
            f"snapshot_encode wants a 2D buffer, got {tuple(buf.shape)}")
    rows, cols = buf.shape
    name = str(buf.dtype).removeprefix("torch.")
    vd = value_dtype or name
    if base is not None and k is not None:
        raise ValueError("lossy k-cap and diff-vs-base are exclusive")
    if base is not None and base.shape != buf.shape:
        raise ValueError(f"base shape {tuple(base.shape)} != buffer "
                         f"{tuple(buf.shape)}")
    dense_nbytes = int(rows * cols * 4)
    chunks = _row_chunks(rows, cols)
    nnz = torch.zeros((), dtype=torch.int64, device=buf.device)
    for r0, r1 in chunks:
        mask = _support_mask(buf[r0:r1],
                             None if base is None else base[r0:r1])
        nnz = torch.maximum(nnz, mask.sum(dim=1).max())
    need_k = max(1, int(nnz))
    k_use = need_k if k is None else max(1, min(k, cols))
    exact = k is None or need_k <= k_use
    if exact:
        k_use = need_k  # never ship more slots than the support needs

    sparse_spec = WireSpec(rows, cols, min(k_use, cols), vd)
    dense_spec = WireSpec(rows, cols, cols, vd, kind="dense")
    if sparse_spec.nbytes >= dense_spec.nbytes:
        # dense fallback: exact (in the wire dtype), one header of slack
        return SnapshotRecord(
            spec=dense_spec, buf=encode(dense_spec, buf), vs_base=False,
            exact=vd == name, dense_nbytes=dense_nbytes, dropped_frac=0.0)
    if exact:
        idx = torch.cat([
            _snapshot_indices_exact(
                _support_mask(buf[r0:r1],
                              None if base is None else base[r0:r1]),
                sparse_spec.k)
            for r0, r1 in chunks])
        vals = torch.gather(buf, 1, idx.to(torch.int64))
        dropped = 0.0
    else:  # lossy top-k by magnitude (base is None here)
        vals, idx = row_topk(buf, sparse_spec.k)
        total = float(_sum_squares(buf))
        kept = float(_sum_squares(vals))
        dropped = 0.0 if total == 0.0 else max(0.0, 1.0 - kept / total)
    return SnapshotRecord(
        spec=sparse_spec, buf=encode(sparse_spec, vals, idx),
        vs_base=base is not None, exact=exact and vd == name,
        dense_nbytes=dense_nbytes, dropped_frac=dropped)


def snapshot_decode(rec: SnapshotRecord, base: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Inverse of ``snapshot_encode``: record (+ the same ``base`` for a
    ``vs_base`` record) -> a new (rows, cols) buffer in the wire dtype,
    bit for bit the encoded one for an exact record. Decodes on
    ``base``'s device when given, else on the record buffer's."""
    spec = rec.spec
    buf = rec.buf if base is None else rec.buf.to(base.device)
    vals, idx = decode(spec, buf)
    if spec.kind == "dense":
        return vals.clone()  # a view of the record's buffer otherwise
    dtype = getattr(torch, spec.value_dtype)
    if rec.vs_base:
        if base is None:
            raise ValueError("record was encoded vs a base buffer")
        out = base.to(dtype, copy=True)
    else:
        out = torch.zeros((spec.rows, spec.cols), dtype=dtype,
                          device=vals.device)
    return out.scatter_(1, idx.to(torch.int64), vals)
