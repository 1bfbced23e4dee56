"""ctypes wrapper for the fused Mem-SGD CUDA kernel (``csrc/fused_memsgd.cu``).

Port of the Pallas TPU kernel ``fused_memsgd_pallas``
(``src/repro/kernels/fused_memsgd.py``): u = m + eta*g, the per-row
top-|.|-k of u, and the residual memory m' = u with the selected entries
zeroed, in one pass over m and g. Like the reference's kernel it has two
selections: ``"loop"`` (k rounds of a warp max) and ``"threshold"`` (the
radix select of ``row_topk_threshold``); both give the same bits.

``fused_memsgd_cuda`` routes on where its tensors lie: a CPU tensor goes
to the plain version (``ref.fused_memsgd_ref``) whatever the selection; a
CUDA tensor launches the selection's kernel, or the wrapper raises.
``fused_memsgd_cuda.launches`` counts every launch and
``SELECTION_LAUNCHES`` the launches of each selection (plain integers;
reset them to 0 to count one run).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import eta32, fused_memsgd_ref

SELECTIONS = ("loop", "threshold")
# the largest row one block holds in shared memory (227 KB of float32;
# the threshold branch keeps 3 KB of scratch beside it), and the most
# rows a grid of int32 row indices addresses
MAX_COLS = {"loop": 232448 // 4, "threshold": (232448 - 3072) // 4}
MAX_ROWS = 2**31 - 1

SELECTION_LAUNCHES = {name: 0 for name in SELECTIONS}


@functools.cache
def _kernel(selection: str):
    lib = _build.load("fused_memsgd")
    fn = (lib.fused_memsgd_threshold_f32 if selection == "threshold"
          else lib.fused_memsgd_f32)
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(m: torch.Tensor, g: torch.Tensor, k: int,
                 selection: str = "loop") -> None:
    """Raise on what the kernel does not take: it reads two contiguous
    float32 (R, C) tensors on one CUDA device, with 1 <= k <= C <=
    MAX_COLS[selection]."""
    if m.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(
            f"fused_memsgd kernel takes float32 m and g, got {m.dtype} and "
            f"{g.dtype} (the bf16 variant is not ported)"
        )
    if m.dim() != 2 or m.shape != g.shape:
        raise ValueError(
            f"fused_memsgd kernel takes two (R, C) tensors of one shape, got "
            f"{tuple(m.shape)} and {tuple(g.shape)}"
        )
    if m.device != g.device:
        raise ValueError(f"m on {m.device} but g on {g.device}")
    if not (m.is_contiguous() and g.is_contiguous()):
        raise ValueError("fused_memsgd kernel takes contiguous m and g")
    C = m.shape[1]
    if not 1 <= k <= C:
        raise ValueError(f"need 1 <= k <= C, got k={k}, C={C}")
    if C > MAX_COLS[selection]:
        raise ValueError(
            f"C={C} exceeds the {MAX_COLS[selection]} columns one block "
            f"holds in shared memory with the {selection} selection (u is "
            "never in device memory, so there is no wider form)"
        )
    if m.shape[0] > MAX_ROWS:
        raise ValueError(f"R={m.shape[0]} exceeds {MAX_ROWS} rows")


def fused_memsgd_cuda(m: torch.Tensor, g: torch.Tensor, eta, k: int,
                      selection: str = "loop",
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(m, g): (R, C) float32; eta a number; ``selection`` "loop" or
    "threshold". Returns (new_m (R, C), vals (R, k), idx (R, k) int32)."""
    if selection not in SELECTIONS:
        raise ValueError(
            f"unknown fused_memsgd selection {selection!r}; options: "
            f"{SELECTIONS}")
    if m.device.type == "cpu" and g.device.type == "cpu":
        return fused_memsgd_ref(m, g, eta, k)
    if m.device.type != "cuda":
        raise ValueError(
            f"fused_memsgd runs on CUDA tensors (or the plain version on "
            f"CPU tensors), got {m.device}"
        )
    check_inputs(m, g, k, selection)
    R, C = m.shape
    new_m = torch.empty_like(m)
    vals = torch.empty((R, k), dtype=torch.float32, device=m.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=m.device)
    if R == 0:
        return new_m, vals, idx
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = _kernel(selection)(
            m.data_ptr(), g.data_ptr(), eta32(eta), R, C, k,
            new_m.data_ptr(), vals.data_ptr(), idx.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_memsgd ({selection}) kernel launch failed: CUDA error {rc}")
    fused_memsgd_cuda.launches += 1
    SELECTION_LAUNCHES[selection] += 1
    return new_m, vals, idx


fused_memsgd_cuda.launches = 0
