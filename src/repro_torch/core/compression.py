"""k-contraction compression operators (paper Definitions 2.1 and 2.2;
port of ``repro.core.compression``).

A k-contraction operator ``comp: R^d -> R^d`` satisfies

    E ||x - comp(x)||^2  <=  (1 - k/d) ||x||^2        (Definition 2.1)

Each operator has two dual forms over a flat vector:

* ``dense(x, gen)  -> R^d``           — the compressed vector, zeros
  elsewhere.
* ``sparse(x, gen) -> (values, idx)`` — the k transmitted (value, index
  int32) pairs.

and ``densify(x, values, idx)`` builds the dense form from the sparse
one, so that one draw gives both (``repro_torch.core.memory``). ``gen``
is a ``torch.Generator`` on the vector's device for the operators that
draw (``needs_rng``), else ignored.

Operators provided
------------------
* ``top_k``           — paper Definition 2.2 (largest-|.| coordinates):
  the vector goes through ``kernels.ops.row_topk`` as one (1, d) row, so
  a CUDA tensor launches the port's top-k kernels. The order is the
  reference's (``jax.lax.top_k`` on |x|): decreasing |x|, ties to the
  lowest index.
* ``rand_k``          — paper Definition 2.2 (uniform random k-subset).
* ``blockwise_top_k`` — exact top-k_b per contiguous block, the (nb,
  block) rows through ``row_topk``.
* ``random_coordinate`` — Remark 2.3 ultra-sparsification: each
  coordinate kept independently with probability k/d.
* ``identity``        — k = d (vanilla SGD), for baselines.

``rand_k`` and ``random_coordinate`` draw from torch's generators, not
from the reference's threefry: they agree with the reference in
distribution, not draw for draw.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels.ops import row_topk

SparsePair = Tuple[torch.Tensor, torch.Tensor]  # (values (k,), idx (k,) int32)
Draw = Optional[torch.Generator]


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A k-contraction operator in dense and sparse form.

    Attributes:
      name: identifier used in configs / logs.
      k_of: maps vector length d -> number of transmitted coordinates k.
      dense: (x, gen) -> compressed dense vector, same shape as x.
      sparse: (x, gen) -> (values, indices) with size k, or None if the
        operator has no fixed-size sparse encoding.
      needs_rng: whether the operator draws from ``gen``.
      densify: (x, values, indices) -> the dense form of a sparse pair
        (None where ``sparse`` is None).
    """

    name: str
    k_of: Callable[[int], float]
    dense: Callable[[torch.Tensor, Draw], torch.Tensor]
    sparse: Optional[Callable[[torch.Tensor, Draw], SparsePair]]
    needs_rng: bool
    densify: Optional[Callable[..., torch.Tensor]] = None


def _set(x_like: torch.Tensor, vals: torch.Tensor,
         idx: torch.Tensor) -> torch.Tensor:
    """zeros like x with vals set at idx (indices distinct)."""
    return torch.zeros_like(x_like).index_copy_(0, idx.to(torch.int64),
                                                vals.to(x_like.dtype))


def _add(x_like: torch.Tensor, vals: torch.Tensor,
         idx: torch.Tensor) -> torch.Tensor:
    """zeros like x with vals added at idx (repeated indices add)."""
    return torch.zeros_like(x_like).index_add_(0, idx.to(torch.int64),
                                               vals.to(x_like.dtype))


def _with_dense(name, k_of, sparse, needs_rng, densify) -> Compressor:
    def dense(x, gen=None):
        return densify(x, *sparse(x, gen))

    return Compressor(name=name, k_of=k_of, dense=dense, sparse=sparse,
                      needs_rng=needs_rng, densify=densify)


# ---------------------------------------------------------------------------
# top_k (Definition 2.2)
# ---------------------------------------------------------------------------


def _topk_sparse(x: torch.Tensor, k: int) -> SparsePair:
    """(values, indices) of the k largest-magnitude entries of x."""
    vals, idx = row_topk(x.reshape(1, -1), k)
    return vals.reshape(-1), idx.reshape(-1)


def top_k(k: int) -> Compressor:
    def sparse(x, gen=None):
        return _topk_sparse(x, min(k, x.numel()))

    return _with_dense(f"top_{k}", lambda d: min(k, d), sparse, False, _set)


def top_k_ratio(ratio: float, k_min: int = 1) -> Callable[[int], int]:
    """k as a fraction of d (used for per-leaf compression of trees)."""

    def k_of(d: int) -> int:
        return max(k_min, min(d, int(round(ratio * d))))

    return k_of


# ---------------------------------------------------------------------------
# rand_k (Definition 2.2)
# ---------------------------------------------------------------------------


def rand_k(k: int) -> Compressor:
    def sparse(x, gen):
        kk = min(k, x.numel())
        idx = torch.randperm(x.numel(), generator=gen, device=x.device)[:kk]
        idx = idx.to(torch.int32)
        return x.reshape(-1)[idx], idx

    return _with_dense(f"rand_{k}", lambda d: min(k, d), sparse, True, _set)


# ---------------------------------------------------------------------------
# blockwise top-k (the per-row top-k over (nb, block) rows)
# ---------------------------------------------------------------------------


def blockwise_top_k(k_per_block: int, block: int = 1024) -> Compressor:
    """Exact top-k_b within each contiguous block of ``block`` entries.

    Per-row top-k over a (rows, cols) bucket == blockwise_top_k(k, cols)
    over the concatenated leaves. Contraction: for each block b of size
    B, top-k_b captures at least the mass of a uniform random k_b-subset,
    whose expected residual is (1 - k_b/B)·||x_b||²; summing over blocks
    gives Definition 2.1 with k/d = k_b/B.
    """

    def sparse(x, gen=None):
        d = x.numel()
        nb = -(-d // block)  # ceil
        pad = nb * block - d
        xb = torch.nn.functional.pad(x.reshape(-1), (0, pad)).reshape(nb, block)
        kk = min(k_per_block, block)
        vals, local_idx = row_topk(xb, kk)  # (nb, kk)
        gidx = local_idx + (torch.arange(nb, dtype=torch.int32,
                                         device=x.device) * block)[:, None]
        # padded positions carry value 0: zero the value and clamp the index
        # so the dense form's add is a no-op for them.
        in_range = gidx < d
        gidx = torch.where(in_range, gidx, 0)
        vals = torch.where(in_range, vals, 0.0)
        return vals.reshape(-1), gidx.reshape(-1).to(torch.int32)

    # ``add`` (not ``set``): padded duplicates at index 0 carry value 0,
    # and real indices are unique within/across blocks.
    return _with_dense(
        f"blocktop_{k_per_block}x{block}",
        lambda d: min(k_per_block, block) * (-(-d // block)),
        sparse, False, _add)


# ---------------------------------------------------------------------------
# random-coordinate ultra-sparsification (Remark 2.3)
# ---------------------------------------------------------------------------


def random_coordinate(k: float) -> Compressor:
    """Keep each coordinate independently with probability k/d, 0 < k <= d.

    Valid even for k < 1 (ultra-sparsification): on average fewer than one
    coordinate is transmitted per step. Support size is random, so only the
    dense form exists.
    """

    def dense(x, gen):
        p = min(k / x.numel(), 1.0)
        keep = torch.rand(x.shape, generator=gen, device=x.device) < p
        return torch.where(keep, x, 0.0)

    return Compressor(
        name=f"randcoord_{k}", k_of=lambda d: min(k, d), dense=dense,
        sparse=None, needs_rng=True,
    )


# ---------------------------------------------------------------------------
# identity (k = d)
# ---------------------------------------------------------------------------


def identity() -> Compressor:
    def dense(x, gen=None):
        return x

    def sparse(x, gen=None):
        return x, torch.arange(x.numel(), dtype=torch.int32, device=x.device)

    def densify(x, vals, idx):
        return vals

    return Compressor(
        name="identity", k_of=lambda d: d, dense=dense, sparse=sparse,
        needs_rng=False, densify=densify,
    )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def make_compressor(name: str, **kw) -> Compressor:
    """Factory from string names used in configs.

    Examples: ``top_k(k=10)``, ``rand_k(k=10)``, ``blockwise(k_per_block=2,
    block=1024)``, ``random_coordinate(k=0.5)``, ``identity``.
    """
    table = {
        "top_k": top_k,
        "rand_k": rand_k,
        "blockwise": blockwise_top_k,
        "random_coordinate": random_coordinate,
        "identity": identity,
    }
    if name not in table:
        raise ValueError(f"unknown compressor {name!r}; options: {sorted(table)}")
    return table[name](**kw)


def contraction_residual(x: torch.Tensor, compressed: torch.Tensor) -> torch.Tensor:
    """||x - comp(x)||^2, the LHS of Definition 2.1 (before expectation)."""
    r = x - compressed
    return torch.sum(torch.square(r))
