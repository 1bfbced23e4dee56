"""Mixture-of-Experts FFN layer (port of ``repro.models.moe``): a top-k
router, capacity-based dispatch by scatter, the experts' products, and
combine by gather.

* Experts live in stacked tensors (E, D, F) / (E, F, D), behind the
  stacked layer axis: (L, E, D, F) / (L, E, F, D) leaves.
* Tokens are routed in GROUPS (one sequence for training, the whole batch
  for single-token decode). Within a group each token's top-k experts
  give it a slot in a capacity buffer (E, C, D) with
  C = max(1, ceil(G * K * capacity_factor / E)); the slot is the token's
  position in the (G * K) assignment list, g-major and k-minor, among
  those routed to that expert. A token past an expert's capacity is
  dropped there: its slot is 0 and its contribution zero.
* Dispatch is K scatter-adds (``index_put_`` with ``accumulate``) into
  (N, E, C, D) and combine K gathers, each weighted by its renormalised
  router probability and summed in k order, so the expert products cost
  the active parameters times the capacity factor, not a one-hot matmul.
* The aux loss is the load-balancing E * sum_e f_e * p_e * weight, f_e the
  fraction of tokens whose top-1 expert is e, p_e the mean probability.

The router's top-K is a stable descending sort cut to K: ``jax.lax.top_k``
gives ties to the lowest expert index, which ``torch.topk`` does not
promise, and the capacity slots depend on that order. The router runs in
float32 on the router weights as the compute dtype rounded them (the
reference casts every float parameter, then promotes). The reference's
sharding hooks around dispatch and combine (``constrain_moe_*``) are
identities unless its launch layer sets a model axis; the port runs no
model axis, so it has none.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_moe(cfg, L: int, dtype, device, generator: Optional[torch.Generator]
             = None) -> dict:
    """Stacked MoE leaves (leading L axis): a float32 router (L, D, E) and
    the experts' (L, E, D, F) gate and up, (L, E, F, D) down, in
    ``dtype``."""
    m = cfg.moe
    E, D, Fe = m.n_experts, cfg.d_model, m.d_expert
    return {
        "router": dense_init((L, D, E), torch.float32, device, generator),
        "w_gate": dense_init((L, E, D, Fe), dtype, device, generator),
        "w_up": dense_init((L, E, D, Fe), dtype, device, generator),
        "w_down": dense_init((L, E, Fe, D), dtype, device, generator),
    }


def capacity(G: int, cfg, capacity_factor: float = 1.25) -> int:
    """Slots per expert for a group of G tokens."""
    m = cfg.moe
    return max(1, math.ceil(G * m.top_k * capacity_factor / m.n_experts))


def router_top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest probabilities along the last
    axis, in decreasing order, ties to the lowest index (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: dict, cfg, xg: torch.Tensor):
    """xg: (N, G, D) grouped tokens -> (top_w (N, G, K) float32, top_i
    (N, G, K) int64, aux ())."""
    m = cfg.moe
    logits = xg.float() @ p["router"].float()  # (N, G, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = router_top_k(probs, m.top_k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    # load balance: fraction of tokens whose top-1 lands on e, vs mean prob
    E = m.n_experts
    top1 = F.one_hot(top_i[..., 0], E).to(torch.float32)
    frac_tokens = torch.mean(top1, dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1))
    aux = torch.sum(frac_tokens * frac_probs) * E * m.aux_loss_weight
    return top_w, top_i, aux


def assign_slots(top_i: torch.Tensor, n_experts: int, C: int):
    """top_i: (N, G, K) -> (keep (N, G, K) bool, slot (N, G, K) int64):
    each assignment's position among those routed to its expert, walking
    the (G * K) list in order; positions past C are dropped (slot 0)."""
    N, G, K = top_i.shape
    flat_e = top_i.reshape(N, G * K)
    counts = torch.cumsum(F.one_hot(flat_e, n_experts), dim=1)
    pos_in_e = (torch.gather(counts, 2, flat_e[..., None])[..., 0] - 1
                ).reshape(N, G, K)
    keep = pos_in_e < C
    return keep, torch.where(keep, pos_in_e, 0)


def moe_ffn_grouped(p: dict, cfg, xg: torch.Tensor,
                    capacity_factor: float = 1.25
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xg: (N, G, D) -> (out (N, G, D), aux ())."""
    m = cfg.moe
    N, G, D = xg.shape
    E, K = m.n_experts, m.top_k
    C = capacity(G, cfg, capacity_factor)
    top_w, top_i, aux = route(p, cfg, xg)
    keep, slot = assign_slots(top_i, E, C)

    n_idx = torch.arange(N, device=xg.device)[:, None]
    buf = xg.new_zeros((N, E, C, D))
    for k in range(K):  # K scatters of (N, G, D)
        contrib = torch.where(keep[:, :, k, None], xg, 0)
        buf.index_put_((n_idx, top_i[:, :, k], slot[:, :, k]), contrib,
                       accumulate=True)

    # expert compute (N, E, C, D) x (E, D, F)
    h = torch.einsum("necd,edf->necf", buf, p["w_gate"])
    u = torch.einsum("necd,edf->necf", buf, p["w_up"])
    y = torch.einsum("necf,efd->necd", F.silu(h) * u, p["w_down"])

    # combine: gather each token's K expert outputs, weight, sum
    out = torch.zeros_like(xg)
    for k in range(K):
        gathered = y[n_idx, top_i[:, :, k], slot[:, :, k]]  # (N, G, D)
        w = (top_w[:, :, k] * keep[:, :, k]).to(gathered.dtype)
        out = out + gathered * w[:, :, None]
    return out, aux


def moe_ffn(p: dict, cfg, x: torch.Tensor, capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Groups: per sequence for S > 1, the whole batch for
    decode (S == 1)."""
    B, S, D = x.shape
    if S == 1:
        out, aux = moe_ffn_grouped(p, cfg, x.reshape(1, B, D),
                                   capacity_factor)
        return out.reshape(B, S, D), aux
    return moe_ffn_grouped(p, cfg, x, capacity_factor)
