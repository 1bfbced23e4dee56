"""ctypes wrappers for the per-row top-k CUDA kernels (``csrc/topk_select.cu``).

Ports of the Pallas TPU kernels of ``src/repro/kernels/topk_select.py``:

* ``row_topk_loop_cuda(x, k)`` launches ``row_topk_loop`` (k rounds of
  a warp-wide key max, over a short candidate list where one exists):
  ``row_topk_pallas(selection="loop")``.
* ``row_topk_threshold_cuda(x, k)`` launches ``row_topk_threshold``
  (the exact k-th largest magnitude by a radix select of four 8-bit
  digits, two at bf16, then the ties in column order and one ordering
  step):
  ``row_topk_tiled_pallas`` and ``row_topk_pallas(selection="threshold")``.
  Both kernels read a row that fits shared memory from device memory
  once, so the TPU kernels' row and column tiles have no counterpart.

Both return (vals (R, k) x.dtype, idx (R, k) int32): per row the k entries
of largest |x|, in decreasing |x|, ties to the lowest column. They route on
where ``x`` lies: a CPU tensor goes to the plain version
(``ref.row_topk_ref``); a CUDA tensor launches a kernel, or the wrapper
raises. Each kernel has a float32 and a bf16 form (``_f32`` / ``_bf16``
entry points), picked by x's dtype; any other dtype raises ``TypeError``
by name. ``LAUNCHES`` counts each kernel's launches per dtype (the bf16
forms' under ``<name>_bf16``; plain integers, set them to 0 to count one
run).

The kernels are persistent; ``csrc/topk_select.cu`` plans each launch
(warps per block, the row buffer in shared memory or the device-memory
form, the grid) from the card's limits, and ``launch_geometry`` reports
that plan. ``mask_live_k`` (plain PyTorch, no kernel) cuts a selection to
a live k at its static shape.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import row_topk_ref

# columns are int32 indices, rows an int32 grid
MAX_COLS = 2**31 - 1
MAX_ROWS = 2**31 - 1

KERNELS = ("row_topk_loop", "row_topk_threshold")
# the kernels' forms by dtype: the suffix of their launch counts' names
# and of their entry points
DTYPES = {torch.float32: ("", "f32"), torch.bfloat16: ("_bf16", "bf16")}
LAUNCHES = {name + suffix: 0 for suffix, _ in DTYPES.values()
            for name in KERNELS}


@dataclass(frozen=True)
class Geometry:
    """How a top-k kernel is launched: ``warps_per_block`` warps (one row
    each at a time) per block, ``blocks`` blocks, ``smem_bytes`` dynamic
    shared memory per block, ``warps_per_sm`` warps resident per SM;
    ``in_smem``: each warp copies its row into a shared-memory buffer
    (else it reads the row from device memory on every pass)."""
    warps_per_block: int
    in_smem: bool
    blocks: int
    smem_bytes: int
    warps_per_sm: int


@functools.cache
def _kernels():
    lib = _build.load("topk_select")
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for suffix, entry in DTYPES.values():
        for name in KERNELS:
            fn = getattr(lib, f"{name}_{entry}")
            fn.argtypes = [p, i, i, i, p, p, p]
            fn.restype = ctypes.c_int
            fns[name + suffix] = fn
    lib.row_topk_plan.argtypes = [i, i, i, i, p]
    lib.row_topk_plan.restype = ctypes.c_int
    fns["plan"] = lib.row_topk_plan
    return fns


def launch_geometry(name: str, rows: int, cols: int, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> Geometry:
    """The plan with which kernel ``name`` (one of ``KERNELS``) would
    launch on an (rows, cols) input of ``dtype`` on a CUDA ``device``."""
    if name not in KERNELS:
        raise ValueError(f"unknown top-k kernel {name!r}; kernels: {KERNELS}")
    check_dtype(dtype)
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = _kernels()["plan"](int(name == "row_topk_threshold"),
                                int(dtype == torch.bfloat16), rows, cols,
                                out)
    if rc != 0:
        raise RuntimeError(f"{name} launch plan failed: CUDA error {rc}")
    w, in_smem, blocks, smem, per_sm = out
    return Geometry(warps_per_block=w, in_smem=bool(in_smem), blocks=blocks,
                    smem_bytes=smem, warps_per_sm=per_sm)


def check_shape(x: torch.Tensor, k: int) -> None:
    """Raise unless x is (R, C) with 1 <= k <= C (both paths)."""
    if x.dim() != 2:
        raise ValueError(f"row top-k takes an (R, C) tensor, got {tuple(x.shape)}")
    C = x.shape[1]
    if not 1 <= k <= C:
        raise ValueError(f"need 1 <= k <= C, got k={k}, C={C}")


def check_dtype(dtype: torch.dtype) -> None:
    """Raise ``TypeError`` by name unless the kernels have a form for
    ``dtype`` (float32, bf16)."""
    if dtype not in DTYPES:
        raise TypeError(
            f"row top-k kernels take float32 or bfloat16, got {dtype}")


def check_inputs(x: torch.Tensor, k: int) -> None:
    """Raise on what the kernels do not take: a contiguous float32 or bf16
    (R, C) tensor with 1 <= k <= C <= MAX_COLS and R <= MAX_ROWS."""
    check_dtype(x.dtype)
    check_shape(x, k)
    if not x.is_contiguous():
        raise ValueError("row top-k kernels take a contiguous tensor")
    if x.shape[1] > MAX_COLS:
        raise ValueError(f"C={x.shape[1]} exceeds {MAX_COLS} columns")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"R={x.shape[0]} exceeds {MAX_ROWS} rows")


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(
            f"row top-k runs on CUDA tensors (or the plain version on CPU "
            f"tensors), got {x.device}")
    return False


def _launch(name: str, x: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    check_inputs(x, k)
    name += DTYPES[x.dtype][0]
    R, C = x.shape
    vals = torch.empty((R, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=x.device)
    if R == 0:
        return vals, idx
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernels()[name](x.data_ptr(), R, C, k, vals.data_ptr(),
                              idx.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return vals, idx


def _row_topk(name: str, x: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_cpu(x):
        check_shape(x, k)
        return row_topk_ref(x, k)
    return _launch(name, x, k)


def row_topk_loop_cuda(x: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-|.|-k by k rounds of a row max (``row_topk_loop``)."""
    return _row_topk("row_topk_loop", x, k)


def row_topk_threshold_cuda(x: torch.Tensor, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-|.|-k by the exact threshold select
    (``row_topk_threshold``)."""
    return _row_topk("row_topk_threshold", x, k)


def mask_live_k(vals: torch.Tensor, idx: torch.Tensor, k_live: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Restrict a contract-ordered top-``k_max`` selection (..., k_max) to
    its first ``k_live`` slots without changing shapes (the reference's
    ``mask_live_k``, plain PyTorch as its is plain jnp): slots ``>=
    k_live`` become (-0.0, 0).

    Every selector returns pairs in decreasing |v|, ties to the lowest
    index, so the first k_live slots of a top-k_max selection ARE the
    top-k_live selection. -0.0 is the additive identity (``x + -0.0 == x``
    bit for bit, both signed zeros included), so the padded slots scatter
    as exact no-ops whatever order a scatter-add takes them in, though a
    pad repeats index 0. ``k_live`` is a host int: the port's step is
    eager, and the wire keeps its static k_max layout."""
    k_live = int(k_live)
    if k_live >= vals.shape[-1]:
        return vals, idx
    vals, idx = vals.clone(), idx.clone()
    vals[..., k_live:] = -0.0
    idx[..., k_live:] = 0
    return vals, idx
