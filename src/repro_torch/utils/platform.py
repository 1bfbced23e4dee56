"""Device selection for the port's entry points.

The port runs on CUDA unless the caller asks for the CPU: the entry
points default to ``"cuda"``, and with no GPU present they raise instead
of running somewhere else. ``"cpu"`` runs every kernel's plain version.
"""
from __future__ import annotations

import torch

PLATFORMS = ("cuda", "cpu")


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
