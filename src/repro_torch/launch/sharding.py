"""The per-leaf sync's column axes (port of the column half of
``repro.launch.sharding``).

The per-leaf sparse sync selects the top-k of each row along one axis of
a parameter, its column axis. The reference picks, per leaf name, an axis
that the tensor-parallel model axis does not shard and whose extent is a
sensible row length; the port keeps the same choice so that both select
over the same rows. Partition specs come with the model axis, which the
port does not run yet.
"""
from __future__ import annotations

from repro_torch.utils.tree import tree_flatten, tree_paths

# leaf name -> (rank of the rule's trailing dims, column axis among them);
# the column half of the reference's _RULES, every family
_COL_RULES = {
    # embeddings / head
    "embed": (2, 1),
    "lm_head": (2, 0),
    # attention
    "wq": (2, 0),
    "wk": (2, 0),
    "wv": (2, 0),
    "wo": (2, 1),
    "bq": (1, 0),
    "bk": (1, 0),
    "bv": (1, 0),
    "q_norm": (1, 0),
    "k_norm": (1, 0),
    # dense mlp
    "w_gate": (2, 0),
    "w_up": (2, 0),
    "w_down": (2, 1),
    # moe (experts stacked on the leading E axis of the trailing dims)
    "router": (2, 1),
    "moe/w_gate": (3, 2),
    "moe/w_up": (3, 2),
    "moe/w_down": (3, 2),
    # rwkv time/channel mix
    "wr": (2, 0),
    "wg": (2, 0),
    "mix_w1": (2, 1),
    "mix_w2": (3, 1),
    "decay_w1": (2, 0),
    "decay_w2": (2, 0),
    "w0": (1, 0),
    "mu": (2, 1),
    "mu_base": (1, 0),
    "mu_k": (1, 0),
    "mu_r": (1, 0),
    "bonus": (2, 1),
    "gn": (2, 1),
    # griffin recurrent block
    "w_in": (2, 0),
    "w_gate_in": (2, 0),
    "conv_w": (2, 0),
    "conv_b": (1, 0),
    "w_a": (2, 0),
    "b_a": (1, 0),
    "w_x": (2, 0),
    "b_x": (1, 0),
    "lam": (1, 0),
    "w_out": (2, 1),
    # griffin mlp
    "w1": (2, 0),
    "w2": (2, 0),
    "w3": (2, 1),
    # norms
    "ln1": (1, 0),
    "ln2": (1, 0),
    "ln_f": (1, 0),
}


def _leaf_name(path) -> str:
    name = path[-1]
    if "moe" in path and name in ("w_gate", "w_up", "w_down"):
        return f"moe/{name}"
    return name


def _col_for(path, ndim: int) -> int:
    """The reference's ``_rule_for`` column: the rule's axis, shifted past
    a stacked layer axis (or other extra leading axes); the last axis for a
    leaf with no rule or with fewer dims than its rule."""
    rule = _COL_RULES.get(_leaf_name(path))
    if rule is None:
        return max(0, ndim - 1)
    rank, col = rule
    if ndim < rank:
        return max(0, ndim - 1)
    return col + (ndim - rank)


def sync_col_axes(param_shapes) -> dict:
    """Tree of ints: the per-leaf sync's column axis for each leaf of a
    parameter tree (tensors, ``meta`` tensors included: only ``.dim()`` is
    read)."""
    leaves, treedef = tree_flatten(param_shapes)
    return treedef.unflatten(
        _col_for(path, leaf.dim())
        for path, leaf in zip(tree_paths(param_shapes), leaves))
