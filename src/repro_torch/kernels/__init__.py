"""Hand-written Hopper kernels of the port and their plain versions.

* ``fused_memsgd`` — ctypes wrapper of ``csrc/fused_memsgd.cu`` (fused
  memory update + per-row top-k), with its launch count.
* ``topk_select``  — ctypes wrappers of ``csrc/topk_select.cu`` (per-row
  top-k: the loop and the threshold kernels), with their launch counts.
* ``ops``          — public entry points (``row_topk``,
  ``fused_memsgd_update``).
* ``ref``          — plain PyTorch versions (the CPU path, and what the
  kernels are held against on the card).
* ``_build``       — nvcc build at first use, loaded through ctypes.
"""
from repro_torch.kernels.ops import (
    fused_memsgd_ref,
    fused_memsgd_update,
    row_topk,
    row_topk_ref,
)
from repro_torch.kernels.ref import densify_rows_ref

__all__ = [
    "row_topk",
    "fused_memsgd_update",
    "row_topk_ref",
    "fused_memsgd_ref",
    "densify_rows_ref",
]
