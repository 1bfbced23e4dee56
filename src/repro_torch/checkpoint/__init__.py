"""Checkpoints of the port: dense ``.npz`` dumps and wire-compressed ones
(``Checkpointer``)."""
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
