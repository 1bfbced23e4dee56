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
CUDA tensor launches the selection's kernel, or the wrapper raises. The
kernel takes float32 m and g, or bf16 m with float32 or bf16 g (its bf16
form, u in bf16 as the reference's ``m + eta.astype(m.dtype) *
g.astype(m.dtype)``; new_m and vals in bf16); any other pair raises
``TypeError`` by name. ``fused_memsgd_cuda.launches`` counts every launch
and ``SELECTION_LAUNCHES`` the launches of each selection per m dtype (the
bf16 form's under ``<selection>_bf16``; plain integers, reset them to 0 to
count one run).

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
# the (m, g) dtypes the kernel takes
BF16, F32 = torch.bfloat16, torch.float32
DTYPE_PAIRS = ((F32, F32), (BF16, F32), (BF16, BF16))
# a warp's shared memory beside its row buffer: the candidate list (2 KB),
# the threshold branch's histogram (1 KB), the mbarrier (padded to 16)
SCRATCH_BYTES = {"loop": 2048 + 16, "threshold": 2048 + 1024 + 16}
SMEM_PER_BLOCK = 232448    # 227 KB, the most one block may use
# the widest row one warp's buffer (the row's bytes rounded up to 16) and
# scratch fit in a block, by m's dtype, and the most rows a grid of int32
# row indices addresses
MAX_COLS_BY_DTYPE = {
    dt: {s: (SMEM_PER_BLOCK - SCRATCH_BYTES[s]) // 16 * 16 // size
         for s in SELECTIONS}
    for dt, size in ((F32, 4), (BF16, 2))}
MAX_COLS = MAX_COLS_BY_DTYPE[F32]
MAX_ROWS = 2**31 - 1

SELECTION_LAUNCHES = {s + suffix: 0 for suffix in ("", "_bf16")
                      for s in SELECTIONS}


@functools.cache
def _kernels():
    lib = _build.load("fused_memsgd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {"loop": lib.fused_memsgd_f32,
           "threshold": lib.fused_memsgd_threshold_f32,
           "loop_bf16": lib.fused_memsgd_bf16,
           "threshold_bf16": lib.fused_memsgd_threshold_bf16,
           "plan": lib.fused_memsgd_plan}
    for name in SELECTIONS:
        fns[name].argtypes = [p, p, f, i, i, i, p, p, p, p]
        # the bf16 form takes whether g is bf16 after g
        fns[name + "_bf16"].argtypes = [p, p, i, f, i, i, i, p, p, p, p]
    fns["plan"].argtypes = [i, i, i, i, i, p]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


def launch_geometry(selection: str, rows: int, cols: int,
                    device: torch.device, m_dtype: torch.dtype = F32,
                    g_dtype: torch.dtype = F32) -> Geometry:
    """The plan with which ``selection``'s branch would launch on an
    (rows, cols) input, m and g of the given dtypes, on a CUDA
    ``device``: a warp for every row, always in shared memory
    (``in_smem``)."""
    check_dtypes(m_dtype, g_dtype)
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = _kernels()["plan"](int(selection == "threshold"),
                                int(m_dtype == BF16), int(g_dtype == BF16),
                                rows, cols, out)
    if rc != 0:
        raise RuntimeError(
            f"fused_memsgd ({selection}) launch plan failed: CUDA error {rc}")
    w, in_smem, blocks, smem, per_sm = out
    return Geometry(warps_per_block=w, in_smem=bool(in_smem), blocks=blocks,
                    smem_bytes=smem, warps_per_sm=per_sm)


def check_dtypes(m_dtype: torch.dtype, g_dtype: torch.dtype) -> None:
    """Raise ``TypeError`` by name unless the kernel has a form for (m, g)
    of these dtypes: (float32, float32), (bf16, float32) or (bf16,
    bf16)."""
    if (m_dtype, g_dtype) not in DTYPE_PAIRS:
        raise TypeError(
            f"fused_memsgd kernel takes float32 m and g, or bfloat16 m with "
            f"float32 or bfloat16 g, got {m_dtype} and {g_dtype}")


def check_inputs(m: torch.Tensor, g: torch.Tensor, k: int,
                 selection: str = "loop") -> None:
    """Raise on what the kernel does not take: it reads two contiguous
    (R, C) tensors of a pair of dtypes it takes (``check_dtypes``) on one
    CUDA device, with 1 <= k <= C <= ``MAX_COLS_BY_DTYPE[m.dtype]
    [selection]``."""
    check_dtypes(m.dtype, g.dtype)
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
    widest = MAX_COLS_BY_DTYPE[m.dtype][selection]
    if C > widest:
        raise ValueError(
            f"C={C} exceeds the {widest} columns one block holds in shared "
            f"memory with the {selection} selection at {m.dtype} (u is "
            "never in device memory, so there is no wider form)"
        )
    if m.shape[0] > MAX_ROWS:
        raise ValueError(f"R={m.shape[0]} exceeds {MAX_ROWS} rows")


def fused_memsgd_cuda(m: torch.Tensor, g: torch.Tensor, eta, k: int,
                      selection: str = "loop",
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(m, g): (R, C), float32 and float32 or bf16 and float32 or bf16;
    eta a number; ``selection`` "loop" or "threshold". Returns (new_m
    (R, C), vals (R, k), both in m's dtype, idx (R, k) int32)."""
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
    vals = torch.empty((R, k), dtype=m.dtype, device=m.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=m.device)
    if R == 0:
        return new_m, vals, idx
    name = selection
    # the bf16 form takes whether g is bf16 after g; eta goes as float32
    # and the kernel rounds it to m's dtype
    g_kind = ()
    if m.dtype == BF16:
        name += "_bf16"
        g_kind = (int(g.dtype == BF16),)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = _kernels()[name](
            m.data_ptr(), g.data_ptr(), *g_kind, eta32(eta), R, C, k,
            new_m.data_ptr(), vals.data_ptr(), idx.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_memsgd ({name}) kernel launch failed: CUDA error {rc}")
    fused_memsgd_cuda.launches += 1
    SELECTION_LAUNCHES[name] += 1
    return new_m, vals, idx


fused_memsgd_cuda.launches = 0
