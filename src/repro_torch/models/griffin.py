"""RecurrentGemma / Griffin (arXiv:2402.19427), port of
``repro.models.griffin``: RG-LRU recurrent blocks and local attention.

Repeating block pattern (default ``rec, rec, attn``: one local-attention
layer per two recurrent layers). Each residual block:

    x -> norm -> temporal (RG-LRU recurrent block OR local MQA) -> +x
      -> norm -> gated-GeLU MLP -> +x

The recurrent block has two input branches (D -> R): the first passes a
causal depthwise conv (width 4) and then the RG-LRU, the second is a GeLU
gate; their product projects back to D. The RG-LRU recurrence (diagonal,
real):

    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)  # c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training evaluates the recurrence with a log-depth scan (``linear_scan``):
ceil(log2(T + 1)) rounds over shifted views, where the reference calls
``jax.lax.associative_scan``. Both sum the same terms in other orders.
Local attention is the shared GQA layer with the config's window
(``layers.attention``: the direct path up to 2048 positions, above it the
windowed blocked path).

The blocks stay a per-layer list of dicts, as in the reference, because
the two kinds hold different leaves. The math follows the reference's
cast points: the params come in the compute dtype (``lam`` too), the
RG-LRU runs in float32 (the bias adds promote to it) and casts its output
back, the conv sums its taps in the compute dtype. ``jax.nn.gelu`` is the
tanh approximation.

Decode (``decode_step``) runs one token per call from each layer's
carried state (``init_state``): the RG-LRU's float32 h and the causal
conv's last (width - 1) inputs for a recurrent layer (``rg_lru_step``,
``recurrent_block_step``), a KV ring buffer of min(max_len, attn_window)
slots for a local-attention layer (``layers.attention_decode``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.utils.platform import resolve_device

LRU_C = 8.0
_F32 = torch.float32


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# init (the port's own seeded draws, with the reference's distributions)
# ---------------------------------------------------------------------------


def _lru_width(cfg) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def layer_kinds(cfg) -> Tuple[str, ...]:
    pat = cfg.hybrid.pattern
    return tuple(pat[i % len(pat)] for i in range(cfg.n_layers))


def init_recurrent_block(cfg, dtype, device, generator=None) -> dict:
    D, R, W = cfg.d_model, _lru_width(cfg), cfg.hybrid.conv_width
    # Lambda so that a^(1/c) ~ U[0.9, 0.999], as in the paper: the inverse
    # softplus of -log(a^(1/c)); float32 whatever the param dtype
    u = torch.rand((R,), generator=generator, device=device)
    lam = torch.log(torch.expm1(-torch.log(u.mul_(0.999 - 0.9).add_(0.9))))
    conv_w = torch.randn((W, R), generator=generator, device=device)
    return {
        "w_in": L.dense_init((D, R), dtype, device, generator),
        "w_gate_in": L.dense_init((D, R), dtype, device, generator),
        "conv_w": conv_w.div_(math.sqrt(W)).to(dtype),
        "conv_b": torch.zeros((R,), dtype=dtype, device=device),
        "w_a": L.dense_init((R, R), dtype, device, generator),
        "b_a": torch.zeros((R,), dtype=dtype, device=device),
        "w_x": L.dense_init((R, R), dtype, device, generator),
        "b_x": torch.zeros((R,), dtype=dtype, device=device),
        "lam": lam,
        "w_out": L.dense_init((R, D), dtype, device, generator),
    }


def init_mlp(cfg, dtype, device, generator=None) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "w1": L.dense_init((D, F_), dtype, device, generator),
        "w2": L.dense_init((D, F_), dtype, device, generator),
        "w3": L.dense_init((F_, D), dtype, device, generator),
    }


def init_block(cfg, kind: str, dtype, device, generator=None) -> dict:
    D = cfg.d_model
    p = {"ln1": torch.ones((D,), dtype=dtype, device=device),
         "ln2": torch.ones((D,), dtype=dtype, device=device)}
    if kind == "rec":
        p["rec"] = init_recurrent_block(cfg, dtype, device, generator)
    else:
        p["attn"] = L.init_attention(cfg, None, dtype, device, generator)
    p["mlp"] = init_mlp(cfg, dtype, device, generator)
    return p


def init_params(cfg, device="cpu", generator: Optional[torch.Generator] = None
                ) -> dict:
    """Parameters drawn from ``generator`` on ``device`` (the ``meta``
    device gives shapes and dtypes without storage); ``blocks`` is a list
    of per-layer trees."""
    dtype = getattr(torch, cfg.param_dtype)
    D, V = cfg.d_model, cfg.padded_vocab
    embed = L.embed_init((V, D), dtype, device, generator)
    blocks = [init_block(cfg, kind, dtype, device, generator)
              for kind in layer_kinds(cfg)]
    return {
        "embed": embed,
        "blocks": blocks,
        "ln_f": torch.ones((D,), dtype=dtype, device=device),
        "lm_head": L.dense_init((D, V), dtype, device, generator),
    }


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 with h_{-1} = 0: the inclusive
    scan of the pairs (a_t, b_t) under (a1, b1) . (a2, b2) = (a1 a2,
    a2 b1 + b2). Log-depth (Hillis-Steele): round d combines each element
    with the one d before it, d = 1, 2, 4, ..., ceil(log2 T) rounds of a
    few whole-tensor ops each; autograd gives the backward."""
    T = a.shape[1]
    d = 1
    while d < T:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        a_cur, b_cur = a[:, d:], b[:, d:]
        b = torch.cat([b[:, :d], a_cur * b_prev + b_cur], dim=1)
        if 2 * d < T:  # the last round's a is not read again
            a = torch.cat([a[:, :d], a_prev * a_cur], dim=1)
        d *= 2
    return b


def rg_lru(p: dict, x: torch.Tensor, h0: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,R); h0: (B,R) float32. Returns (y (B,T,R) in x's dtype,
    h_T float32)."""
    xf = x.to(_F32)
    r = torch.sigmoid(xf @ p["w_a"].to(_F32) + p["b_a"])
    i = torch.sigmoid(xf @ p["w_x"].to(_F32) + p["b_x"])
    log_a = -LRU_C * F.softplus(p["lam"]) * r  # (B,T,R), negative
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) * (
        i * xf)
    # h0 as the t = -1 element: h_t = a_t h_{t-1} + b_t over T + 1 elements
    a_ext = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
    b_ext = torch.cat([h0[:, None, :].to(_F32), gated], dim=1)
    y = linear_scan(a_ext, b_ext)[:, 1:]
    return y.to(x.dtype), y[:, -1]


def rg_lru_step(p: dict, x: torch.Tensor, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the RG-LRU. x: (B, R); h: (B, R) float32. Returns (y
    in x's dtype, the new h in float32)."""
    xf = x.to(_F32)
    r = torch.sigmoid(xf @ p["w_a"].to(_F32) + p["b_a"])
    i = torch.sigmoid(xf @ p["w_x"].to(_F32) + p["b_x"])
    a = torch.exp(-LRU_C * F.softplus(p["lam"]) * r)
    h = a * h + torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) * (
        i * xf)
    return h.to(x.dtype), h


def causal_conv(p: dict, x: torch.Tensor,
                carry: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width W. x: (B,T,R); carry: (B,W-1,R).
    The taps sum in order, ((x0 w0 + x1 w1) + ...) + b, in x's dtype."""
    W = p["conv_w"].shape[0]
    B, T, R = x.shape
    if carry is None:
        carry = torch.zeros((B, W - 1, R), dtype=x.dtype, device=x.device)
    xp = torch.cat([carry, x], dim=1)
    out = xp[:, 0:T] * p["conv_w"][0]
    for i in range(1, W):
        out = out + xp[:, i:i + T] * p["conv_w"][i]
    return out + p["conv_b"], xp[:, -(W - 1):]


def recurrent_block(p: dict, x: torch.Tensor, state: dict
                    ) -> Tuple[torch.Tensor, dict]:
    """x: (B,T,D); state: {h (B,R) float32, conv (B,W-1,R)}."""
    main = x @ p["w_in"]
    gate = _gelu(x @ p["w_gate_in"])
    main, conv_carry = causal_conv(p, main, state["conv"])
    y, h = rg_lru(p, main, state["h"])
    out = (y * gate) @ p["w_out"]
    return out, {"h": h, "conv": conv_carry}


def recurrent_block_step(p: dict, x: torch.Tensor, state: dict
                         ) -> Tuple[torch.Tensor, dict]:
    """One token of the recurrent block. x: (B, 1, D); state: {h (B, R)
    float32, conv (B, W-1, R): the conv's last W - 1 inputs}. The conv is
    the reference's step form: the window's W products summed at once,
    which ``jnp.sum`` accumulates in float32 and rounds to the compute
    dtype once (the training conv rounds each tap's sum)."""
    main = x[:, 0] @ p["w_in"]
    gate = _gelu(x[:, 0] @ p["w_gate_in"])
    window = torch.cat([state["conv"], main[:, None, :]], dim=1)  # (B, W, R)
    prod = window * p["conv_w"][None]
    conv_out = torch.sum(prod.to(_F32), dim=1).to(prod.dtype) + p["conv_b"]
    y, h = rg_lru_step(p, conv_out, state["h"])
    out = (y * gate) @ p["w_out"]
    return out[:, None, :], {"h": h, "conv": window[:, 1:]}


def gated_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (_gelu(x @ p["w1"]) * (x @ p["w2"])) @ p["w3"]


# ---------------------------------------------------------------------------
# model-level forward
# ---------------------------------------------------------------------------


def init_state(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> list:
    """Each layer's zero decode state on ``device`` (the card unless the
    caller asks for the CPU), a list as the blocks are: {h (B, R) float32,
    conv (B, W-1, R) in ``dtype``} for a recurrent layer, {k, v (B, C, KV,
    hd) in ``dtype``} with C = min(max_len, attn_window) for an attention
    layer."""
    device = resolve_device(device)
    R, W = _lru_width(cfg), cfg.hybrid.conv_width
    Ca = min(max_len, cfg.hybrid.attn_window)
    states = []
    for kind in layer_kinds(cfg):
        if kind == "rec":
            states.append({
                "h": torch.zeros((batch, R), dtype=_F32, device=device),
                "conv": torch.zeros((batch, W - 1, R), dtype=dtype,
                                    device=device)})
        else:
            kv = (batch, Ca, cfg.n_kv_heads, cfg.hd)
            states.append({
                "k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device)})
    return states


def forward(params: dict, cfg, tokens: torch.Tensor, prefix_embeds=None,
            window: Optional[int] = None, last_only: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, T) -> (logits (B, T, V_padded), aux_loss ());
    ``last_only``: the final position's logits only, (B, 1, V_padded)."""
    del prefix_embeds
    B, T = tokens.shape
    dt = getattr(torch, cfg.compute_dtype)
    dev = tokens.device
    x = params["embed"][tokens].to(dt)
    positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    attn_window = window or cfg.hybrid.attn_window
    R, W = _lru_width(cfg), cfg.hybrid.conv_width
    for blk, kind in zip(params["blocks"], layer_kinds(cfg)):
        h_in = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
        if kind == "rec":
            st = {"h": torch.zeros((B, R), dtype=_F32, device=dev),
                  "conv": torch.zeros((B, W - 1, R), dtype=h_in.dtype,
                                      device=dev)}
            t_out, _ = recurrent_block(blk["rec"], h_in, st)
        else:
            t_out = L.attention(blk["attn"], cfg, h_in, positions,
                                attn_window)
        x = x + t_out
        x = x + gated_mlp(blk["mlp"], L.rmsnorm(blk["ln2"], x, cfg.norm_eps))
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    logits = x @ params["lm_head"].to(x.dtype)
    return logits, torch.zeros((), dtype=_F32, device=dev)


def decode_step(params: dict, cfg, cache: dict, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, dict]:
    """cache: {"layers": [each layer's state], "index": a host int}.
    tokens: (B,) -> (logits (B, V_padded), the new cache). An attention
    layer writes its KV ring in place; a recurrent layer's state is
    replaced. The cache passed in is consumed (the reference donates it):
    use the returned one."""
    dt = getattr(torch, cfg.compute_dtype)
    x = params["embed"][tokens][:, None, :].to(dt)
    idx = cache["index"]
    new_states = []
    for blk, kind, st in zip(params["blocks"], layer_kinds(cfg),
                             cache["layers"]):
        h_in = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
        if kind == "rec":
            t_out, st = recurrent_block_step(blk["rec"], h_in, st)
        else:
            t_out = L.attention_decode(blk["attn"], cfg, h_in, st["k"],
                                       st["v"], idx, cfg.hybrid.attn_window)
        x = x + t_out
        x = x + gated_mlp(blk["mlp"], L.rmsnorm(blk["ln2"], x, cfg.norm_eps))
        new_states.append(st)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = x[:, 0] @ params["lm_head"].to(x.dtype)
    return logits, {"layers": new_states, "index": idx + 1}
