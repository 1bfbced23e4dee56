"""Error-feedback memory (the 'Memory' in Mem-SGD; port of
``repro.core.memory``).

The memory vector m_t accumulates the information suppressed by the
compression operator and re-injects it in later steps:

    u_t    = m_t + eta_t * g_t          (gradient scaled at INSERTION time)
    out_t  = comp_k(u_t)                (what is applied / transmitted)
    m_{t+1}= u_t - out_t                (residual kept)

``memory_step`` is the per-tensor primitive; ``tree_memory_step`` runs it
on every leaf of a gradient tree, one compressor per leaf. Models with
many leaves use the bucket-space memory of ``repro_torch.core.buckets``
instead (``memsgd_bucketed``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.compression import Compressor
from repro_torch.utils.tree import tree_flatten, tree_map


class MemoryUpdate(NamedTuple):
    """Result of one error-feedback compression step on one tensor."""

    applied: torch.Tensor  # dense comp_k(m + eta*g), same shape as g
    new_memory: torch.Tensor  # m' = m + eta*g - applied
    sparse: Optional[Tuple[torch.Tensor, torch.Tensor]]  # (values, indices)


def memory_step(
    compressor: Compressor,
    memory: torch.Tensor,
    grad: torch.Tensor,
    eta: float,
    gen: Optional[torch.Generator] = None,
) -> MemoryUpdate:
    """One Mem-SGD line-4/6 step on a flat tensor (any shape; flattened).

    The reference draws its dense and its sparse form from the same key,
    so that both select the same coordinates. A ``torch.Generator`` drawn
    from twice would draw twice, so an operator with a sparse form draws
    once: the dense form is that pair densified."""
    shape = grad.shape
    u = memory.reshape(-1) + eta * grad.reshape(-1).to(memory.dtype)
    if compressor.sparse is not None:
        sparse = compressor.sparse(u, gen)
        applied_flat = compressor.densify(u, *sparse)
    else:
        sparse = None
        applied_flat = compressor.dense(u, gen)
    new_mem = u - applied_flat
    return MemoryUpdate(
        applied=applied_flat.reshape(shape),
        new_memory=new_mem.reshape(shape) if memory.dim() == len(shape) else new_mem,
        sparse=sparse,
    )


def init_memory(params, dtype=torch.float32):
    """Zero memory tree matching ``params`` (m_0 = 0), on their devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device),
                    params)


def tree_memory_step(
    compressor_for_leaf: Callable[[torch.Tensor], Compressor],
    memory_tree,
    grad_tree,
    eta: float,
    gen: Optional[torch.Generator] = None,
):
    """Apply ``memory_step`` to every leaf of a gradient tree.

    ``compressor_for_leaf`` maps a leaf (by its shape) to the Compressor
    to use — this is how per-tensor k is expressed (e.g. k = ratio *
    leaf_size). The leaves draw from ``gen`` one after another (the
    reference splits its key per leaf).

    Returns (applied_tree, new_memory_tree).
    """
    leaves, treedef = tree_flatten(grad_tree)
    mem_leaves = treedef.flatten_up_to(memory_tree)
    applied, new_mem = [], []
    for g, m in zip(leaves, mem_leaves):
        upd = memory_step(compressor_for_leaf(g), m, g, eta, gen)
        applied.append(upd.applied)
        new_mem.append(upd.new_memory.reshape(m.shape))
    return treedef.unflatten(applied), treedef.unflatten(new_mem)
