"""Public entry points for the port's kernels (counterpart of
``repro.kernels.ops``).

``method`` keeps the reference's names and validation ("auto", "loop",
"threshold"); every method gives the same contract (decreasing |v|, ties
to the lowest index) and, in the port, runs the same kernel: the CUDA
kernel's k rounds of warp max serve the main path's small k. A threshold
(bisection) kernel for large k is later work.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_memsgd import fused_memsgd_cuda

# the reference's Pallas tile height; see fused_memsgd_update
DEFAULT_ROW_BLOCK = 8
METHODS = ("auto", "loop", "threshold")


def _resolve_method(method: str) -> str:
    if method not in METHODS:
        raise ValueError(f"unknown top-k method {method!r}")
    return method


def fused_memsgd_update(
    m: torch.Tensor, g: torch.Tensor, eta, k: int,
    row_block: int = DEFAULT_ROW_BLOCK, method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused u = m + eta*g -> per-row top-k -> residual memory.

    Returns (new_m (R, C), vals (R, k), idx (R, k) int32). ``row_block``
    is the reference's tile height, kept for call compatibility: the
    reference pads R up to a multiple of it because a Pallas tile holds
    ``row_block`` whole rows. The CUDA kernel gives each row its own warp
    and masks the ragged edge itself, so no padding is needed and the
    value does not change the result.
    """
    _resolve_method(method)
    if row_block < 1:
        raise ValueError(f"row_block must be >= 1, got {row_block}")
    return fused_memsgd_cuda(m, g, eta, k)


# re-exported for tests and for the card's comparison
row_topk_ref = ref.row_topk_ref
fused_memsgd_ref = ref.fused_memsgd_ref
