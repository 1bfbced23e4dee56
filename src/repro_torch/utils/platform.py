"""Device selection and per-device tables for the port's entry points.

The port runs on CUDA unless the caller asks for the CPU: the entry
points default to ``"cuda"``, and with no GPU present they raise instead
of running somewhere else. ``"cpu"`` runs every kernel's plain version.

``topk_loop_cutover(device)`` is the k up to which the loop top-k
(k rounds of a warp max over a row's candidates) beats the threshold
select (a radix select of the k-th largest magnitude over the same
candidates), per device type; ``kernels.ops.row_topk(method="auto")``
and the per-leaf sync's ``threshold_onehot`` selection read it.
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
# H100 80GB HBM3 at 700 W the loop kernel wins at every swept k up to 16
# at C = 2560 and up to 12 at C = 1024, where the threshold kernel already
# wins at 14, by a few percent or less either side (PERF.md). Both
# kernels' times grow slowly with k, so the choice moves little time.
TOPK_LOOP_CUTOVER = {
    "cpu": 4,
    "cuda": 12,
}


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
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
