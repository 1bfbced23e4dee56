"""Device selection and per-device tables for the port's entry points.

The port runs on CUDA unless the caller asks for the CPU: the entry
points default to ``"cuda"``, and with no GPU present they raise instead
of running somewhere else. ``"cpu"`` runs every kernel's plain version.

``topk_loop_cutover(device)`` is the k up to which the loop top-k
(k rounds of a warp max over a row's candidates) beats the threshold
select (a radix select of the k-th largest magnitude over the same
candidates), per device type; ``kernels.ops.row_topk(method="auto")``
and the per-leaf sync's ``threshold_onehot`` selection read it.
``fused_loop_cutover(device, dtype)`` is the same for the two branches of
the fused Mem-SGD kernel, by m's dtype, which ``kernels.ops.
fused_memsgd_update(method="auto")`` reads (the bucketed paths, and
``bucket_memory_step`` over bf16 memory).
"""
from __future__ import annotations

import torch

PLATFORMS = ("cuda", "cpu")

# Largest k at which the loop select still beats the threshold select.
# "cpu" is the reference's entry (src/repro/utils/platform.py, measured
# there on its interpret-mode CPU kernels; on the CPU both methods run the
# same plain version, so it only keeps "auto" resolving as the reference
# does). "cuda" is the loop-against-threshold sweep that chip_smoke.py
# prints for the kernels of csrc/topk_select.cu (two passes over the row,
# then the rounds or the radix digits on a candidate list): on an NVIDIA
# H100 80GB HBM3 at 700 W the loop kernel wins at every swept k up to 26
# at C = 2560 and at C = 1024 and loses from k = 32 (PERF.md), since its
# rounds sort and shift only the list slots a lane holds (it was 12
# before that).
TOPK_LOOP_CUTOVER = {
    "cpu": 4,
    "cuda": 26,
}

# Largest k at which the fused kernel's loop branch still beats its
# threshold branch. "cpu" is the reference's entry, as above (its fused
# update resolves "auto" from the same table as its top-k). "cuda" is the
# fused sweep that chip_smoke.py prints for csrc/fused_memsgd.cu at
# qwen3-4b's (1154560, 1024) bucket, the median of 8 runs a branch at each
# k: on an NVIDIA H100 80GB HBM3 at 700 W the threshold branch's median is
# 0.1-0.5% lower at every k up to 29 (the bucketed path's k = 10, the
# topk preset's k = 20) in two runs of the sweep, the two overlap at
# 30-32, and the threshold branch is 2-17% faster above 32, where the
# loop branch repeats its two passes per 32 rounds (PERF.md). So the card
# takes the threshold branch at every k; the loop branch runs when it is
# asked for by name.
FUSED_LOOP_CUTOVER = {
    "cpu": 4,
    "cuda": 0,
}
# The same for the fused kernel's bf16 form (bf16 m, u in bf16). "cuda" is
# the bf16 fused sweep that chip_smoke.py prints at qwen3-4b's (1154560,
# 1024) bucket with float32 g (what bucket_memory_step packs; the sweep
# is made with float32 g only): on an NVIDIA H100 80GB HBM3 at 700 W the
# loop branch's median is 3.5-11% lower at every swept k up to 26 and the
# threshold branch's 15-62% lower from k = 32 on (PERF.md), as at the pod
# sync's (496345, 1024). With bf16 g the threshold branch was 2-4% ahead
# at k = 10 and 20 (timed, not swept).
FUSED_LOOP_CUTOVER_BF16 = {
    "cpu": 4,
    "cuda": 26,
}


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``: the card (raising when there is
    none) or the CPU; the ``meta`` device (shapes and dtypes, no storage)
    passes through."""
    dev = torch.device(device)
    if dev.type == "meta":
        return dev
    if dev.type not in PLATFORMS:
        raise ValueError(f"unsupported device {dev}; options: {PLATFORMS}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no GPU is available; pass device='cpu' "
            "(--platform cpu) to run the plain versions on the CPU"
        )
    return dev


def topk_loop_cutover(device="cpu") -> int:
    """The loop-against-threshold top-k cutover for ``device``'s type."""
    dev = torch.device(device)
    if dev.type not in TOPK_LOOP_CUTOVER:
        raise ValueError(f"no top-k cutover for device {dev}")
    return TOPK_LOOP_CUTOVER[dev.type]


def fused_loop_cutover(device="cpu", dtype=torch.float32) -> int:
    """The fused kernel's loop/threshold cutover for ``device``'s type and
    m's ``dtype``."""
    dev = torch.device(device)
    table = (FUSED_LOOP_CUTOVER_BF16 if dtype == torch.bfloat16
             else FUSED_LOOP_CUTOVER)
    if dev.type not in table:
        raise ValueError(f"no fused cutover for device {dev}")
    return table[dev.type]
