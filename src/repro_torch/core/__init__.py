"""Core of the port: the bucketed engine, bucketed Mem-SGD and the sync.

* ``repro_torch.core.buckets``     — flat-buffer engine (tree -> buckets).
* ``repro_torch.core.memsgd``      — Algorithm 1 as a GradientTransformation.
* ``repro_torch.core.distributed`` — PARALLEL-MEM-SGD bucketed sync.
"""
