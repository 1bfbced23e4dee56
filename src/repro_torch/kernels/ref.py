"""Plain PyTorch versions of the port's kernels.

Same contract as the reference's oracles (``repro.kernels.ref``):

* ``row_topk_ref(x, k)`` — per-row top-k by |.|: for each row of x (R, C)
  the k largest-magnitude entries as (values (R, k), idx (R, k) int32), in
  decreasing magnitude, ties broken by the LOWEST index. This is the
  iterative argmax (``torch.argmax`` returns the first maximal index on
  CPU and CUDA alike); ``torch.topk`` promises no tie order, so it is not
  used. It is the plain version of both top-k kernels (``row_topk_loop``
  and ``row_topk_threshold``) and of every ``ops.row_topk`` method: the
  contract fixes the output uniquely, so any exact algorithm returns it
  bit for bit and no second plain version (a threshold select) is needed.
* ``fused_memsgd_ref(m, g, eta, k)`` — the fused Mem-SGD step:
      u      = m + eta * g
      vals,i = row_topk(u, k)
      m'     = u with the selected entries zeroed
  returning (m', vals, idx), all in m's dtype (idx int32). As the
  reference's ``m + eta.astype(m.dtype) * g.astype(m.dtype)``, eta is
  rounded to m's dtype (``eta_as``) and g cast to it; ``eta * g`` and the
  sum are two separate ops, each computed in float32 and rounded once to
  m's dtype, exactly as the CUDA kernel computes them (``__fmul_rn`` then
  ``__fadd_rn``, then ``__float2bfloat16_rn`` after each at bf16), so the
  two agree bit for bit.

On the CPU these are the path itself; on the card they are what the
kernels are held against.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def eta32(eta) -> float:
    """eta rounded to float32 once, as the kernel receives it."""
    return float(np.float32(eta))


def eta_as(eta, dtype: torch.dtype) -> float:
    """eta rounded to ``dtype`` as the reference's ``jnp.asarray(eta,
    dtype)`` rounds it: to float32, then (bf16) to nearest even. The
    float32 step makes the difference where eta lies within a float32 ulp
    of a bf16 midpoint (0.370117187499 rounds up to 0.37109375, not down
    to 0.369140625)."""
    e = eta32(eta)
    if dtype == torch.float32:
        return e
    return torch.tensor(e, dtype=torch.float32).to(dtype).item()


def row_topk_ref(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    R, _ = x.shape
    absx = torch.abs(x).to(torch.float32)
    vals = torch.empty((R, k), dtype=x.dtype, device=x.device)
    idxs = torch.empty((R, k), dtype=torch.int32, device=x.device)
    rows = torch.arange(R, device=x.device)
    for i in range(k):
        j = torch.argmax(absx, dim=1)  # first max: lowest index on ties
        vals[:, i] = x[rows, j]
        idxs[:, i] = j.to(torch.int32)
        absx[rows, j] = float("-inf")
    return vals, idxs


def densify_rows_ref(x_like: torch.Tensor, vals: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """Scatter per-row (vals, idx) pairs back to a dense (R, C) tensor of
    ``x_like``'s shape and dtype (indices must be distinct in a row)."""
    return torch.zeros_like(x_like).scatter_(
        1, idx.to(torch.int64), vals.to(x_like.dtype)
    )


def fused_memsgd_ref(m: torch.Tensor, g: torch.Tensor, eta, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    step = torch.mul(g.to(m.dtype), eta_as(eta, m.dtype))
    u = torch.add(m, step)
    del step
    vals, idxs = row_topk_ref(u, k)
    new_m = u.scatter_(1, idxs.to(torch.int64), 0.0)  # u is ours: in place
    return new_m, vals, idxs
