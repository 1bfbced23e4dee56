"""Public entry points for the port's kernels (counterpart of
``repro.kernels.ops``).

``method`` keeps the reference's names and validation:

* ``"loop"``      — k rounds of a row max (``row_topk_loop``).
* ``"threshold"`` — the exact k-th largest magnitude by a radix select
  of its bit pattern (``row_topk_threshold``).
* ``"auto"``      — threshold for k above the device's measured cutover
  (``repro_torch.utils.platform.topk_loop_cutover``), loop otherwise.

Every method gives the same contract (decreasing |v|, ties to the lowest
index), so all of them return bitwise-identical outputs. On CPU tensors
every method runs the plain version (``ref.row_topk_ref`` /
``ref.fused_memsgd_ref``). ``fused_memsgd_update`` runs the fused
kernel's branch of the method's name; its "auto" reads the fused kernel's
own measured cutover for m's dtype (``platform.fused_loop_cutover``),
since its two branches are not the top-k kernels and were measured on
their own, at float32 and at bf16.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_memsgd import fused_memsgd_cuda
from repro_torch.kernels.topk_select import (
    row_topk_loop_cuda,
    row_topk_threshold_cuda,
)
from repro_torch.utils.platform import fused_loop_cutover, topk_loop_cutover

# the reference's Pallas tile height; see fused_memsgd_update
DEFAULT_ROW_BLOCK = 8
METHODS = ("auto", "loop", "threshold")


def _resolve_method(method: str, k: int, device="cpu",
                    cutover=topk_loop_cutover) -> str:
    """The kernel that ``method`` names at ``k`` on ``device``: "auto"
    takes the threshold kernel for k above ``cutover(device)``."""
    if method == "auto":
        return "threshold" if k > cutover(device) else "loop"
    if method not in METHODS:
        raise ValueError(f"unknown top-k method {method!r}")
    return method


def row_topk(x: torch.Tensor, k: int, method: str = "auto"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-|.|-k of x (R, C) -> (vals (R, k), idx (R, k) int32).

    The reference's ``row_block`` and ``col_block`` (its Pallas tile
    sizes) have no counterpart: the CUDA kernels give each row its own
    warp, read the whole row and mask the ragged edge themselves."""
    if _resolve_method(method, k, x.device) == "threshold":
        return row_topk_threshold_cuda(x, k)
    return row_topk_loop_cuda(x, k)


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
    selection = _resolve_method(
        method, k, m.device,
        functools.partial(fused_loop_cutover, dtype=m.dtype))
    if row_block < 1:
        raise ValueError(f"row_block must be >= 1, got {row_block}")
    return fused_memsgd_cuda(m, g, eta, k, selection)


# re-exported for tests and for the card's comparison
row_topk_ref = ref.row_topk_ref
fused_memsgd_ref = ref.fused_memsgd_ref
