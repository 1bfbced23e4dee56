"""QSGD (Alistarh et al., NIPS 2017): the paper's quantization baseline
(§4.3) and the quantizer half of the Qsparse-local-SGD composition (port
of ``repro.optim.qsgd``).

QSGD quantizes each coordinate to one of s levels of |g|/||g||_2 with
stochastic rounding, so that the quantized vector is an UNBIASED
estimator of g:

    Q_s(g)_i = ||g||_2 * sign(g_i) * xi_i(g, s)

where xi_i = (l+1)/s with probability |g_i|/||g|| * s - l, else l/s,
with l = floor(|g_i|/||g|| * s).

``quantize_rows`` is the bucket-space form: the norm is per row of an
(..., C) tensor, and the output is the wire code of ``core.encoding``'s
quantized tier, ``(level << 1) | sign_bit``, with the float32 row norm.
Its noise is an argument: a float32 tensor of uniforms in [0, 1) of the
values' shape (the reference's draws, injected by the tests), or a
``torch.Generator``. The sync draws it from a ``QuantNoise``, which
stands where the reference folds PRNG keys. Dequantization is
``core.encoding.dequantize_rows``, the one formula every consumer
applies.

The row norm is summed in one fixed order on every device (``row_norm``),
so the card's codes are the CPU's on the same uniforms. The reference's
``sqrt(sum(square(v), -1))`` takes its order from XLA's compiler, which
picks it by row length (a sequential sum at 5 columns, an FMA chain at
10 to 26, a vector-lane order at 41 and 64), so its last bit is not
reproducible in another framework (``torch.sum`` differs from it in the
last bit of many rows). Where every partial sum is exact in float32
(dyadic values), every order gives the reference's norm; elsewhere the
two stay within 2 ulp (``tests/test_torch_qsgd.py``)."""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple, Union

import torch

from repro_torch.core.encoding import dequantize_rows
from repro_torch.optim.base import GradientTransformation, times_f32
from repro_torch.optim.sgd import as_schedule
from repro_torch.utils.tree import tree_flatten

Noise = Union[torch.Tensor, torch.Generator]

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class QuantNoise:
    """The rounding noise of one sync: a keyed source of uniforms.

    ``uniforms(bucket, level, index, shape, device)`` returns
    ``torch.rand(shape)`` from a generator on ``device`` seeded with a
    fixed 64-bit mix (splitmix64, chained) of ``(seed, step, bucket,
    level, index)``: the reference's fold chain, PRNGKey(seed) then the
    step, the bucket, the level tag and the axis indices. At level 1 the
    index is the worker's global rank (noise unique to the worker); at
    level 2 it is the pod, so every worker of a pod draws the same noise
    and quantizes the shared pod summary to the same codes. The draws
    differ by device (a CUDA generator is not the CPU's); the tests
    inject the reference's own draws through an object with this
    method."""

    def __init__(self, seed: int, step: int):
        self.seed, self.step = int(seed), int(step)

    def key(self, bucket: int, level: int, index: int) -> int:
        h = 0
        for x in (self.seed, self.step, bucket, level, index):
            h = _splitmix64(h ^ (int(x) & _MASK64))
        return h >> 1  # a non-negative 63-bit seed

    def uniforms(self, bucket: int, level: int, index: int, shape,
                 device) -> torch.Tensor:
        gen = torch.Generator(device=device)
        gen.manual_seed(self.key(bucket, level, index))
        return torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                          device=device)


def row_norm(v: torch.Tensor) -> torch.Tensor:
    """The float32 L2 norm of each row of v (..., C), in one order on
    every device: the squares, then a pairwise tree of adds over the
    columns (column j + column j + half, the odd one carried), each op a
    separate rounded tensor op (no reduction kernel, no FMA), then the
    square root taken in float64 and rounded once to float32: the
    correctly rounded float32 root on either device (the CPU's float32
    ``torch.sqrt`` is vectorized within half an ulp and misrounds some
    values the card's rounds correctly)."""
    sq = torch.mul(v, v)
    while sq.shape[-1] > 1:
        half = sq.shape[-1] // 2
        pairs = torch.add(sq[..., :half], sq[..., half:2 * half])
        sq = (torch.cat([pairs, sq[..., 2 * half:]], dim=-1)
              if sq.shape[-1] % 2 else pairs)
    return torch.sqrt(sq[..., 0].to(torch.float64)).to(torch.float32)


def quantize_rows(vals: torch.Tensor, s: int, noise: Noise
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic s-level quantization of (..., C) rows -> (norms (...,)
    float32, codes (..., C) int32), the reference's formula step for step:
    r = |v| / norm * s, lo = floor(r), p_up = clip(r - lo, 0, 1), the
    level lo + (uniform < p_up) capped at s, and its sign bit apart.

    Unbiased per entry: E[dequantize_rows(norms, codes, s)] == vals. An
    exact -0.0 (the runtime-k padded tail) gives code 1 (level 0, sign 1),
    which dequantizes to -0.0; a zero-norm row gives level 0 throughout.
    ``noise``: uniforms of ``vals.shape`` (float32, on the values' device)
    or a generator to draw them from."""
    v = vals.to(torch.float32)
    if isinstance(noise, torch.Generator):
        noise = torch.rand(v.shape, generator=noise, dtype=torch.float32,
                           device=v.device)
    if tuple(noise.shape) != tuple(v.shape):
        raise ValueError(f"noise shape {tuple(noise.shape)} != values shape "
                         f"{tuple(v.shape)}")
    norm = row_norm(v)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    r = torch.mul(torch.div(torch.abs(v), safe.unsqueeze(-1)), float(s))
    lo = torch.floor(r)
    p_up = torch.clamp(torch.sub(r, lo), 0.0, 1.0)
    up = (noise.to(torch.float32) < p_up).to(torch.float32)
    level = torch.clamp(torch.add(lo, up), max=float(s))
    sign = torch.signbit(v).to(torch.int32)
    return norm, (level.to(torch.int32) << 1) | sign


def qsgd_quantize(g: torch.Tensor, s: int, noise: Noise) -> torch.Tensor:
    """Unbiased s-level stochastic quantization (quantize, then
    dequantize), in g's dtype. Rows are the trailing axis; a 1-D vector
    is the paper's whole-vector normalization."""
    norm, codes = quantize_rows(g, s, noise)
    return dequantize_rows(norm, codes, s).to(g.dtype)


class QSGDState(NamedTuple):
    count: int
    gen: torch.Generator


def qsgd(eta: Union[Callable[[int], float], float], s: int,
         seed: int = 0) -> GradientTransformation:
    """SGD on QSGD-quantized gradients, each leaf quantized as one vector:
    x' = x - eta_t * Q_s(g). The noise comes from one generator per
    transformation, seeded with ``seed`` on the first leaf's device (the
    reference splits a PRNG key per leaf and step)."""
    sched = as_schedule(eta)

    def init(params):
        leaves = tree_flatten(params)[0]
        device = leaves[0].device if leaves else torch.device("cpu")
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        return QSGDState(count=0, gen=gen)

    def update(grads, state: QSGDState, params=None, **_):
        leaves, treedef = tree_flatten(grads)
        e = sched(state.count)
        out = [times_f32(-e, qsgd_quantize(g.reshape(-1), s, state.gen)
                         .reshape(g.shape)).to(g.dtype) for g in leaves]
        return treedef.unflatten(out), QSGDState(count=state.count + 1,
                                                 gen=state.gen)

    return GradientTransformation(init, update)

