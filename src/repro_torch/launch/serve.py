"""Serving path on one device: prefill and batched greedy decode (port of
``repro.launch.serve``).

``make_serve_step`` consumes ONE new token per sequence against the
family's cache (``Model.init_cache``: a KV cache, ring-buffered under a
window, or a recurrent state) and returns the greedy next tokens;
``decode_loop`` teacher-forces a prompt into the cache and then
generates. Decode writes the cache in place (the reference donates it):
each call returns the cache to pass to the next.

Replica refresh: ``apply_delta`` consumes the trainer's packed per-step
delta messages (``repro_torch.launch.delta_stream``), so that a replica
tracks training without dense parameter broadcasts. A replica held
beside a trainer must be a ``replica_copy``: the port's train step
updates the params in place.

Not ported: ``serve_shardings`` and the expert-parallel ``moe_ep``
constraints, which need the model axis (a sharded parameter layout)
that the port does not run yet.
"""
from __future__ import annotations

import torch

# a serving replica's refresh from one trainer delta message, in place
from repro_torch.launch.delta_stream import apply_delta  # noqa: F401
from repro_torch.utils.tree import tree_map


def replica_copy(tree):
    """A deep copy of a tree of tensors into fresh, unaliased storage.

    The port's train step updates params IN PLACE (the reference donates
    them): a serving replica, a fan-out hub's base or any other copy held
    across trainer steps must go through this helper, or it silently
    follows the trainer. Non-tensor leaves are kept as they are."""
    return tree_map(lambda x: x.detach().clone()
                    if isinstance(x, torch.Tensor) else x, tree)


def _no_moe_ep(moe_ep: bool) -> None:
    if moe_ep:
        raise NotImplementedError(
            "moe_ep (expert-parallel MoE serving) needs the model axis, "
            "which the port does not run yet; serve with moe_ep=False")


def greedy_tokens(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Argmax over the real vocabulary: the padded logits past
    ``vocab_size`` are masked to -inf, ties go to the first index
    (``torch.argmax``'s order, as ``jnp.argmax``'s). (B, Vp) -> (B,)
    int32."""
    Vp = logits.shape[-1]
    real = torch.arange(Vp, device=logits.device) < vocab_size
    masked = torch.where(real, logits, float("-inf"))
    return torch.argmax(masked, dim=-1).to(torch.int32)


def make_serve_step(model, batch: int, moe_ep: bool = False):
    """(params, cache, tokens (B,)) -> (next tokens (B,) int32, cache),
    for caches of ``model.init_cache(batch, ...)`` (the reference's
    ``max_len`` and ``cache_dtype`` arguments shape its shardings, which
    a one-device step has none of)."""
    _no_moe_ep(moe_ep)
    V = model.cfg.vocab_size

    def step(params, cache, tokens):
        if tuple(tokens.shape) != (batch,):
            raise ValueError(f"tokens of shape {tuple(tokens.shape)} for a "
                             f"serve step of batch {batch}")
        logits, cache = model.decode_step(params, cache, tokens)
        return greedy_tokens(logits, V), cache

    return step


def make_prefill_step(model, shape_cfg, moe_ep: bool = False):
    """(params, batch) -> last-position logits (B, V_padded): the LM head
    on the final position only (``Model.prefill_logits``), for batches of
    ``shape_cfg``'s (a ``configs.ShapeConfig``) global batch and
    length."""
    _no_moe_ep(moe_ep)

    def step(params, batch):
        if tuple(batch["tokens"].shape) != (shape_cfg.global_batch,
                                            shape_cfg.seq_len):
            raise ValueError(
                f"tokens of shape {tuple(batch['tokens'].shape)} for the "
                f"{shape_cfg.name} shape ({shape_cfg.global_batch}, "
                f"{shape_cfg.seq_len})")
        return model.prefill_logits(params, batch)

    return step


def decode_loop(model, params, prompts: torch.Tensor, n_tokens: int,
                max_len: int, cache_dtype=torch.bfloat16) -> torch.Tensor:
    """Greedy generation on the prompts' device: consumes ``prompts`` (B,
    PL) token by token (teacher-forcing ``prompts[:, :PL-1]`` into the
    cache, the reference's order), then generates ``n_tokens`` greedily
    from ``prompts[:, PL-1]`` on. Returns (B, n_tokens) int32."""
    B, PL = prompts.shape
    step = make_serve_step(model, B)
    cache = model.init_cache(B, max_len, cache_dtype, device=prompts.device)
    tok = prompts[:, 0]
    for t in range(PL - 1):
        _, cache = step(params, cache, tok)
        tok = prompts[:, t + 1]  # teacher-force the prompt
    out = []
    for _ in range(n_tokens):
        tok, cache = step(params, cache, tok)
        out.append(tok)
    return torch.stack(out, dim=1)
