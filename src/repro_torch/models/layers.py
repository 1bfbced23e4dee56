"""Shared layers of the port's models (port of ``repro.models.layers``).

Parameters are nested dicts of tensors, in the reference's layouts: dense
weights are (d_in, d_out) and applied as ``x @ W``. Functions take
``(params, inputs, ...)`` and are plain PyTorch (autograd gives the
backward). The math follows the reference op for op: fp32 statistics in
the norm, fp32 attention logits and softmax, the same masking constant.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.utils.tree import tree_flatten

# the direct attention path materializes (B, H, S, T) logits; the
# reference switches to blocked attention above this many positions
FLASH_THRESHOLD = 2048


# ---------------------------------------------------------------------------
# init helpers (the port's own seeded init: torch.Generator draws cannot
# reproduce jax.random, so parity tests carry the reference's params over)
# ---------------------------------------------------------------------------


def dense_init(shape, dtype, device, generator=None) -> torch.Tensor:
    """N(0, 1/d_in) weights of ``shape`` = (..., d_in, d_out)."""
    scale = 1.0 / math.sqrt(shape[-2])
    w = torch.randn(shape, generator=generator, device=device)
    return w.mul_(scale).to(dtype)


def embed_init(shape, dtype, device, generator=None) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, device=device)
    return w.mul_(0.02).to(dtype)


def unstack_layers(blocks: dict, n: int) -> list:
    """The stacked block tree (leading L axis on every leaf) as ``n``
    per-layer trees. ``torch.unbind`` takes every layer's view in one op,
    so the backward stacks the layer gradients once instead of adding
    ``n`` zero-padded slices."""
    leaves, treedef = tree_flatten(blocks)
    per_leaf = [torch.unbind(x) for x in leaves]
    return [treedef.unflatten([u[i] for u in per_leaf]) for i in range(n)]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm with fp32 statistics, output in the input dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf * rstd).to(x.dtype) * scale.to(x.dtype)


def groupnorm_heads(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    """Per-head group norm of the RWKV wkv output. x: (..., H, hd); float32
    statistics (population variance), output in the input dtype."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    xc = xf - mean
    var = torch.mean(torch.square(xc), dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions.to(torch.float32)[..., None] * freqs  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional qk-norm / bias / sliding window)
# ---------------------------------------------------------------------------


def init_attention(cfg, L: int, dtype, device, generator=None) -> dict:
    """Stacked attention leaves (leading L axis)."""
    hd, D = cfg.hd, cfg.d_model
    p = {
        "wq": dense_init((L, D, cfg.n_heads * hd), dtype, device, generator),
        "wk": dense_init((L, D, cfg.n_kv_heads * hd), dtype, device, generator),
        "wv": dense_init((L, D, cfg.n_kv_heads * hd), dtype, device, generator),
        "wo": dense_init((L, cfg.n_heads * hd, D), dtype, device, generator),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((L, n * hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((L, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((L, hd), dtype=dtype, device=device)
    return p


def _qkv(p, cfg, x):
    B, S, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _sdpa(q, k, v, mask, n_rep: int) -> torch.Tensor:
    """Direct attention in the reference's math: fp32 logits, masked to
    -1e30, fp32 softmax, probabilities cast to v's dtype.
    q: (B,S,H,hd); k,v: (B,T,KV,hd); mask: broadcastable to (B,H,S,T)."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    KV = k.shape[2]
    qh = q.reshape(B, S, KV, n_rep, hd)
    logits = torch.einsum("bsgrh,btgh->bgrst", qh.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    logits = logits.reshape(B, H, S, T)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    probs = probs.reshape(B, KV, n_rep, S, T)
    out = torch.einsum("bgrst,btgh->bsgrh", probs.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def causal_mask(S: int, window: Optional[int] = None, device=None
                ) -> torch.Tensor:
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    m = j <= i
    if window is not None:
        m = m & (j > i - window)
    return m[None, None]  # (1, 1, S, S)


def attention(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
              window: Optional[int] = None) -> torch.Tensor:
    """Causal (training) attention through the direct path."""
    B, S, _ = x.shape
    if S > FLASH_THRESHOLD:
        raise NotImplementedError(
            f"attention over S={S} > {FLASH_THRESHOLD} positions needs the "
            "blocked path, which is not ported yet")
    q, k, v = _qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = _sdpa(q, k, v, causal_mask(S, window, x.device), n_rep)
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_swiglu(L: int, d_model: int, d_ff: int, dtype, device,
                generator=None) -> dict:
    return {
        "w_gate": dense_init((L, d_model, d_ff), dtype, device, generator),
        "w_up": dense_init((L, d_model, d_ff), dtype, device, generator),
        "w_down": dense_init((L, d_ff, d_model), dtype, device, generator),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
