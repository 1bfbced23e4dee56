"""Optimizer protocol of the port (``base``)."""
from repro_torch.optim.base import GradientTransformation

__all__ = ["GradientTransformation"]
