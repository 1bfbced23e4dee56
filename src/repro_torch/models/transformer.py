"""Decoder-only transformer, dense GQA and MoE variants (port of
``repro.models.transformer``: the forward, prefill's ``last_only`` and the
one-token decode against a KV cache).

Covers the reference's families:
  dense: qwen1.5-4b (qkv bias), yi-9b, qwen3-4b (qk_norm), granite-3-8b,
         musicgen-medium (audio prefix embeds), internvl2-26b (vision
         prefix embeds)
  moe:   qwen3-moe-30b-a3b, granite-moe-3b-a800m

Layers are STACKED as in the reference (leading L axis on every block
leaf, so the experts are (L, E, D, F) and (L, E, F, D)), so parameters
carry over one to one and the bucket plan matches; the forward walks the
stack with a Python loop where the reference scans, and sums the MoE
layers' aux losses in layer order as its scan carry does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.utils.platform import resolve_device


def init_params(cfg, device="cpu", generator: Optional[torch.Generator] = None
                ) -> dict:
    """Stacked parameters drawn from ``generator`` on ``device`` (the
    ``meta`` device gives shapes and dtypes without storage)."""
    dtype = getattr(torch, cfg.param_dtype)
    n, D = cfg.n_layers, cfg.d_model
    # drawn in the order embed, attention, ffn, lm_head
    embed = L.embed_init((cfg.padded_vocab, D), dtype, device, generator)
    blocks = {
        "ln1": torch.ones((n, D), dtype=dtype, device=device),
        "ln2": torch.ones((n, D), dtype=dtype, device=device),
        "attn": L.init_attention(cfg, n, dtype, device, generator),
    }
    if cfg.moe is not None:
        blocks["moe"] = moe_lib.init_moe(cfg, n, dtype, device, generator)
    else:
        blocks["mlp"] = L.init_swiglu(n, D, cfg.d_ff, dtype, device,
                                      generator)
    p = {
        "embed": embed,
        "blocks": blocks,
        "ln_f": torch.ones((D,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init((D, cfg.padded_vocab), dtype, device,
                                    generator)
    return p


def _block_apply(cfg, p, x, positions, window):
    """One layer -> (x, its aux loss, None for a dense layer)."""
    h = x + L.attention(p["attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                        positions, window)
    hn = L.rmsnorm(p["ln2"], h, cfg.norm_eps)
    if cfg.moe is not None:
        ff, aux = moe_lib.moe_ffn(p["moe"], cfg, hn)
        return h + ff, aux
    return h + L.swiglu(p["mlp"], hn), None


def embed_tokens(cfg, params, tokens: torch.Tensor,
                 prefix_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings in the compute dtype; with ``n_prefix_embeddings``
    = P and ``prefix_embeds`` (B, P, D) given, those replace the first P
    positions."""
    dt = getattr(torch, cfg.compute_dtype)
    x = params["embed"][tokens].to(dt)
    if cfg.n_prefix_embeddings and prefix_embeds is not None:
        P = cfg.n_prefix_embeddings
        x = torch.cat([prefix_embeds.to(dt), x[:, P:]], dim=1)
    return x


def forward(params: dict, cfg, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            window: Optional[int] = None, last_only: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, V_padded), aux_loss ()).

    ``last_only`` applies the LM head to the final position only, (B, 1,
    V_padded) logits (prefill)."""
    B, S = tokens.shape
    window = window if window is not None else cfg.sliding_window
    x = embed_tokens(cfg, params, tokens, prefix_embeds)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in L.unstack_layers(params["blocks"], cfg.n_layers):
        x, a = _block_apply(cfg, blk, x, positions, window)
        if a is not None:
            aux = aux + a
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return _lm_head(cfg, params, x), aux


def _lm_head(cfg, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T.to(x.dtype)
    return x @ params["lm_head"].to(x.dtype)


# ---------------------------------------------------------------------------
# decode (one token against the KV cache)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """Stacked KV cache (L, B, C, KV, hd) with C = min(max_len, window)
    (a ring buffer under a sliding window), zeros in ``dtype`` on
    ``device`` (the card unless the caller asks for the CPU), and the
    decode position ``index``, a host int (the reference's () int32)."""
    device = resolve_device(device)
    C = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (cfg.n_layers, batch, C, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


def decode_step(params: dict, cfg, cache: dict, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, dict]:
    """tokens: (B,) -> (logits (B, V_padded), cache). Each layer writes its
    k and v into its slice of the stacked cache in place; the returned
    cache holds those tensors and ``index`` + 1. A MoE layer routes the
    batch's B tokens as one group (``moe.moe_ffn`` at S == 1)."""
    dt = getattr(torch, cfg.compute_dtype)
    x = params["embed"][tokens][:, None, :].to(dt)  # (B, 1, D)
    idx = cache["index"]
    for i, blk in enumerate(L.unstack_layers(params["blocks"],
                                             cfg.n_layers)):
        h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
        x = x + L.attention_decode(blk["attn"], cfg, h, cache["k"][i],
                                   cache["v"][i], idx, cfg.sliding_window)
        hn = L.rmsnorm(blk["ln2"], x, cfg.norm_eps)
        if cfg.moe is not None:
            ff, _ = moe_lib.moe_ffn(blk["moe"], cfg, hn)
        else:
            ff = L.swiglu(blk["mlp"], hn)
        x = x + ff
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = _lm_head(cfg, params, x[:, 0])
    return logits, {"k": cache["k"], "v": cache["v"], "index": idx + 1}
