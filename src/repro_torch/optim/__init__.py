"""Optimizers of the port (``repro.optim``'s names): the
GradientTransformation protocol, SGD, momentum, Adam, QSGD (the paper's
quantization baseline, and the quantizer of Qsparse-local-SGD) and the
schedules."""
from repro_torch.optim.base import (
    GradientTransformation,
    apply_updates,
    chain,
    identity_tx,
    scale,
    scale_by_schedule,
)
from repro_torch.optim.sgd import sgd, sgd_momentum, add_weight_decay, clip_by_global_norm
from repro_torch.optim.adam import adam
from repro_torch.optim.qsgd import QuantNoise, qsgd, qsgd_quantize, quantize_rows
from repro_torch.optim import schedules

__all__ = [
    "GradientTransformation",
    "apply_updates",
    "chain",
    "identity_tx",
    "scale",
    "scale_by_schedule",
    "sgd",
    "sgd_momentum",
    "add_weight_decay",
    "clip_by_global_norm",
    "adam",
    "QuantNoise",
    "qsgd",
    "qsgd_quantize",
    "quantize_rows",
    "schedules",
]
