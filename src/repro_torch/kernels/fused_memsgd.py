"""ctypes wrapper for the fused Mem-SGD CUDA kernel (``csrc/fused_memsgd.cu``).

Port of the Pallas TPU kernel ``fused_memsgd_pallas``
(``src/repro/kernels/fused_memsgd.py``): u = m + eta*g, the per-row
top-|.|-k of u, and the residual memory m' = u with the selected entries
zeroed, in one pass over m and g. Like the reference's kernel it has two
selections: ``"loop"`` (k rounds of a warp max on a candidate list, the
select of ``row_topk_loop``) and ``"threshold"`` (the radix select of
``row_topk_threshold``); both give the same bits.

``fused_memsgd_cuda`` routes on where its tensors lie: a CPU tensor goes
to the plain version (``ref.fused_memsgd_ref``) whatever the selection; a
CUDA tensor launches the selection's kernel, or the wrapper raises.
``fused_memsgd_cuda.launches`` counts every launch and
``SELECTION_LAUNCHES`` the launches of each selection (plain integers;
reset them to 0 to count one run).

The source plans each launch from the card's limits, and
``launch_geometry`` reports that plan.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import eta32, fused_memsgd_ref
from repro_torch.kernels.topk_select import Geometry

SELECTIONS = ("loop", "threshold")
# a warp's shared memory beside its row buffer: the candidate list (2 KB),
# the threshold branch's histogram (1 KB), the mbarrier (padded to 16)
SCRATCH_BYTES = {"loop": 2048 + 16, "threshold": 2048 + 1024 + 16}
SMEM_PER_BLOCK = 232448    # 227 KB, the most one block may use
# the widest row one warp's buffer (the row's bytes rounded up to 16) and
# scratch fit in a block, and the most rows a grid of int32 row indices
# addresses
MAX_COLS = {s: (SMEM_PER_BLOCK - SCRATCH_BYTES[s]) // 16 * 16 // 4
            for s in SELECTIONS}
MAX_ROWS = 2**31 - 1

SELECTION_LAUNCHES = {name: 0 for name in SELECTIONS}


@functools.cache
def _kernels():
    lib = _build.load("fused_memsgd")
    p, i = ctypes.c_void_p, ctypes.c_int
    args = [p, p, ctypes.c_float, i, i, i, p, p, p, p]
    fns = {"loop": lib.fused_memsgd_f32,
           "threshold": lib.fused_memsgd_threshold_f32,
           "plan": lib.fused_memsgd_plan}
    for name in SELECTIONS:
        fns[name].argtypes = args
    fns["plan"].argtypes = [i, i, i, p]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


def launch_geometry(selection: str, rows: int, cols: int,
                    device: torch.device) -> Geometry:
    """The plan with which ``selection``'s branch would launch on an
    (rows, cols) float32 input on a CUDA ``device``: a warp for every row,
    always in shared memory (``in_smem``)."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = _kernels()["plan"](int(selection == "threshold"), rows, cols,
                                out)
    if rc != 0:
        raise RuntimeError(
            f"fused_memsgd ({selection}) launch plan failed: CUDA error {rc}")
    w, in_smem, blocks, smem, per_sm = out
    return Geometry(warps_per_block=w, in_smem=bool(in_smem), blocks=blocks,
                    smem_bytes=smem, warps_per_sm=per_sm)


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
        rc = _kernels()[selection](
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
