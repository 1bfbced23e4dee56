"""Shared layers of the port's models (port of ``repro.models.layers``).

Parameters are nested dicts of tensors, in the reference's layouts: dense
weights are (d_in, d_out) and applied as ``x @ W``. Functions take
``(params, inputs, ...)`` and are plain PyTorch (autograd gives the
backward). The math follows the reference op for op: fp32 statistics in
the norm, fp32 attention logits and softmax, the same masking constant.
"""
from __future__ import annotations

import collections
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.utils.tree import tree_flatten

# the direct attention path materializes (B, H, S, T) logits; the
# reference switches to blocked attention above this many positions
FLASH_THRESHOLD = 2048
# the blocked paths' query and key/value block (the reference's runtime
# min(1024, S))
FLASH_BLOCK = 1024
# calls of each attention branch ("direct", "flash_full",
# "flash_windowed"), counted on the host; reset to count one run
ATTENTION_CALLS = collections.Counter()


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


def init_attention(cfg, L: Optional[int], dtype, device, generator=None
                   ) -> dict:
    """Attention leaves, stacked (leading L axis) or, for ``L=None``, one
    layer's."""
    hd, D = cfg.hd, cfg.d_model
    Ls = () if L is None else (L,)
    p = {
        "wq": dense_init(Ls + (D, cfg.n_heads * hd), dtype, device, generator),
        "wk": dense_init(Ls + (D, cfg.n_kv_heads * hd), dtype, device,
                         generator),
        "wv": dense_init(Ls + (D, cfg.n_kv_heads * hd), dtype, device,
                         generator),
        "wo": dense_init(Ls + (cfg.n_heads * hd, D), dtype, device, generator),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros(Ls + (n * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(Ls + (hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones(Ls + (hd,), dtype=dtype, device=device)
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


# -- blocked (flash-style) attention ------------------------------------------
#
# The direct path materializes (B, H, S, T) logits. Above FLASH_THRESHOLD
# positions the reference takes one of two blocked forms, plain jnp, and
# so does the port, in plain PyTorch with autograd for the backward:
# causal attention over query blocks and, inside, key/value blocks with a
# running max and sum (float32 statistics); sliding-window attention over
# query blocks, each against its static span of window + q_block keys.
# The reference feeds the operands to einsum(..., preferred_element_type=
# float32): exact products of the compute dtype's values, summed in
# float32. The port upcasts the operands to float32 for the same products
# (a bf16 product on the card would round its output to bf16), and rounds
# the probabilities to the compute dtype before the second product, as
# the reference's ``p.astype(q.dtype)`` does.


def _check_blocks(S: int, **blocks) -> None:
    for name, b in blocks.items():
        if S % b:
            raise ValueError(
                f"blocked attention over S={S} positions needs S to be a "
                f"multiple of its {name} of {b}")


def _flash_full(q, k, v, n_rep: int, q_block: int, kv_block: int
                ) -> torch.Tensor:
    """Causal blocked attention. q: (B,S,H,hd); k,v: (B,S,KV,hd).

    The reference scans every key/value block for each query block; a
    block wholly above the diagonal is all masked, adds exp(-1e30 - m) = 0
    to the sum and leaves the running max, so the port skips it: the same
    values, half the work."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    _check_blocks(S, q_block=q_block, kv_block=kv_block)
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    kpos_all = torch.arange(S, device=q.device)
    outs = []
    for q0 in range(0, S, q_block):
        qg = qf[:, q0:q0 + q_block].reshape(B, q_block, KV, n_rep, hd)
        qpos = kpos_all[q0:q0 + q_block]
        m = torch.full((B, KV, n_rep, q_block), -math.inf,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KV, n_rep, q_block, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, q0 + q_block, kv_block):
            logits = torch.einsum("bqgrh,bkgh->bgrqk", qg,
                                  kf[:, k0:k0 + kv_block]) * scale
            mask = kpos_all[k0:k0 + kv_block][None, :] <= qpos[:, None]
            logits = torch.where(mask, logits, -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgh->bgrqh", p.to(q.dtype).to(torch.float32),
                vf[:, k0:k0 + kv_block])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,KV,rep,qb,hd)
        outs.append(out.movedim(3, 1).reshape(B, q_block, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def _flash_windowed(q, k, v, n_rep: int, window: int, q_block: int
                    ) -> torch.Tensor:
    """Sliding-window causal attention: each query block against its
    static span of ``window + q_block`` keys (left-padded with zeros)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    _check_blocks(S, q_block=q_block)
    span = window + q_block
    scale = 1.0 / math.sqrt(hd)
    pad = (0, 0, 0, 0, window, 0)  # `window` zero positions in front
    kp = F.pad(k.to(torch.float32), pad)
    vp = F.pad(v.to(torch.float32), pad)
    qf = q.to(torch.float32)
    outs = []
    for start in range(0, S, q_block):
        qg = qf[:, start:start + q_block].reshape(B, q_block, KV, n_rep, hd)
        logits = torch.einsum("bqgrh,bkgh->bgrqk", qg,
                              kp[:, start:start + span]) * scale
        qpos = start + torch.arange(q_block, device=q.device)
        kpos = start + torch.arange(span, device=q.device) - window
        mask = ((kpos[None, :] <= qpos[:, None])
                & (kpos[None, :] > qpos[:, None] - window)
                & (kpos[None, :] >= 0))
        p = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
        out = torch.einsum("bgrqk,bkgh->bgrqh",
                           p.to(q.dtype).to(torch.float32),
                           vp[:, start:start + span])
        outs.append(out.movedim(3, 1).reshape(B, q_block, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
              window: Optional[int] = None) -> torch.Tensor:
    """Causal (training) attention; picks the direct path up to
    FLASH_THRESHOLD positions, above it the windowed blocked path when a
    window shorter than S binds, else the causal blocked path."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    block = min(FLASH_BLOCK, S)
    if S <= FLASH_THRESHOLD:
        ATTENTION_CALLS["direct"] += 1
        out = _sdpa(q, k, v, causal_mask(S, window, x.device), n_rep)
    elif window is not None and window < S:
        ATTENTION_CALLS["flash_windowed"] += 1
        out = _flash_windowed(q, k, v, n_rep, window, block)
    else:
        ATTENTION_CALLS["flash_full"] += 1
        out = _flash_full(q, k, v, n_rep, block, block)
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]


def attention_decode(p: dict, cfg, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cur_index: int,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token decode against a KV cache, ring-buffered when windowed
    (the reference's ``attention_decode``).

    x: (B, 1, D). cache_k, cache_v: (B, C, KV, hd) with C = min(max_len,
    window). ``cur_index``: the tokens already in the cache (a host int).
    The token's k and v, RoPE'd at the absolute position ``cur_index``,
    are written IN PLACE to slot ``cur_index % C`` (the reference donates
    the cache and returns the updated one); the query attends to the
    slots ``j < min(cur_index + 1, C)``: all C once the ring is full.
    ``window`` is the reference's argument, whose two branches mask
    alike. Returns out (B, 1, D)."""
    del window
    B = x.shape[0]
    C = cache_k.shape[1]
    q, k, v = _qkv(p, cfg, x)
    pos = torch.full((B, 1), cur_index, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    slot = cur_index % C
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    valid = torch.arange(C, device=x.device) < min(cur_index + 1, C)
    out = _sdpa(q, cache_k, cache_v, valid[None, None, None, :],
                cfg.n_heads // cfg.n_kv_heads)
    # _sdpa's output comes in the cache's dtype: JAX promotes a bf16 one
    # against float32 weights, torch's matmul wants one dtype
    out = out.to(torch.promote_types(out.dtype, p["wo"].dtype))
    return out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"]


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
