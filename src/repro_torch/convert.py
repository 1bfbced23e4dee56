"""Carry parameters and memory between the reference and the port.

Both packages keep the same tree and the same tensor layouts (dense
weights (d_in, d_out), a leading L axis on stacked block leaves), so a
conversion is a leafwise copy through numpy:

    params = params_from_jax(jax.tree.map(np.asarray, ref_params), device)

The reference holds each worker's memory behind a leading worker axis:
(W, rows, cols) per bucket on the bucketed path, (W,) + shape per leaf on
the per-leaf path. A worker of the port holds only its own memory, so
these take worker 0's and put back an axis of 1.

The train driver's optimizer state carries over leafwise too: () for
``memsgd`` and ``dense``, a param-shaped float32 tree for
``memsgd_momentum``, {"mu": tree, "nu": tree} for ``adam_compressed``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: the reference's arrays are read-only
    if a.dtype.name == "bfloat16":  # torch.from_numpy has no bf16: the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree_of_numpy, device="cpu"):
    """The reference's params (a nested dict of numpy arrays, e.g. from
    ``model.init(PRNGKey(0))``) as the port's params on ``device``."""
    return tree_map(lambda a: _to_torch(a, device), tree_of_numpy)


def params_to_jax(params):
    """The port's params as a nested dict of numpy arrays, for the
    reference."""
    return tree_map(_to_numpy, params)


def memory_from_jax(memory, device="cpu"):
    """Reference memory -> worker 0's: a tuple of bucket buffers
    (W, rows, cols) -> (rows, cols), or a per-leaf tree (W,) + shape ->
    shape."""
    if isinstance(memory, dict):
        return tree_map(lambda a: _to_torch(np.asarray(a)[0], device), memory)
    return tuple(_to_torch(np.asarray(b)[0], device) for b in memory)


def memory_to_jax(memory):
    """Port memory -> the reference's, with a worker axis of 1: bucket
    buffers (rows, cols) -> (1, rows, cols), or a per-leaf tree shape ->
    (1,) + shape."""
    if isinstance(memory, dict):
        return tree_map(lambda t: _to_numpy(t)[None], memory)
    return tuple(_to_numpy(b)[None] for b in memory)


def opt_from_jax(opt, device="cpu"):
    """The reference driver's optimizer state (numpy leaves) as the
    port's on ``device``: () stays (), a momentum tree or Adam's
    {"mu", "nu"} trees are copied leafwise."""
    if isinstance(opt, dict):
        return tree_map(lambda a: _to_torch(a, device), opt)
    return ()
