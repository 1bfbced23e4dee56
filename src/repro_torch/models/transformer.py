"""Decoder-only transformer, dense family (port of the dense half of
``repro.models.transformer``; qwen3-4b runs here).

Layers are STACKED as in the reference (leading L axis on every block
leaf), so parameters carry over one to one and the bucket plan matches;
the forward walks the stack with a Python loop where the reference scans.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import layers as L


def init_params(cfg, device="cpu", generator: Optional[torch.Generator] = None
                ) -> dict:
    """Stacked parameters drawn from ``generator`` on ``device`` (the
    ``meta`` device gives shapes and dtypes without storage)."""
    dtype = getattr(torch, cfg.param_dtype)
    n, D = cfg.n_layers, cfg.d_model
    p = {
        "embed": L.embed_init((cfg.padded_vocab, D), dtype, device, generator),
        "blocks": {
            "ln1": torch.ones((n, D), dtype=dtype, device=device),
            "ln2": torch.ones((n, D), dtype=dtype, device=device),
            "attn": L.init_attention(cfg, n, dtype, device, generator),
            "mlp": L.init_swiglu(n, D, cfg.d_ff, dtype, device, generator),
        },
        "ln_f": torch.ones((D,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init((D, cfg.padded_vocab), dtype, device,
                                    generator)
    return p


def _block_apply(cfg, p, x, positions, window):
    h = x + L.attention(p["attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                        positions, window)
    hn = L.rmsnorm(p["ln2"], h, cfg.norm_eps)
    return h + L.swiglu(p["mlp"], hn)


def forward(params: dict, cfg, tokens: torch.Tensor,
            window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, V_padded), aux_loss ())."""
    B, S = tokens.shape
    window = window if window is not None else cfg.sliding_window
    x = params["embed"][tokens].to(getattr(torch, cfg.compute_dtype))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    for blk in L.unstack_layers(params["blocks"], cfg.n_layers):
        x = _block_apply(cfg, blk, x, positions, window)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T.to(x.dtype)
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
