"""RWKV-6 "Finch" (arXiv:2404.05892), port of ``repro.models.rwkv``:
attention-free, data-dependent decay.

Per-head linear-attention-style recurrence with a matrix state
S_t in R^{n x n} (n = head_dim):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)          # u = "bonus"

with data-dependent per-channel decay w_t and ddlerp token-shift, then a
per-head group norm, SiLU gating and the output projection. Channel-mix
is the Finch squared-ReLU MLP with token-shift.

The math follows the reference op for op, with its cast points: the
params come in the compute dtype, ``w0 + lora`` sums there before the
float32 sigmoid, the WKV recurrence runs in float32 (chunk 16 and the
decay clamp 4 keep its within-chunk exponent |cum| <= 64 inside float32)
and casts its output back, the group norm keeps float32 statistics.

Training runs the chunkwise form. Everything inside a chunk (the decayed
queries and keys, the strictly-lower pairwise term, the bonus diagonal,
each chunk's own contribution to the state) depends on no state, so it is
computed for all chunks at once; only the carry of the (n x n) state from
chunk to chunk, ``S' = diag(A) S + KV``, is a Python loop, one op per
chunk, in float32. Block leaves are stacked (leading L axis) as in the
reference, and the forward walks the stack with a Python loop where the
reference scans. ``decode_step`` runs one token per call from the
carried state (``init_state``), each layer's scan fallback at T = 1.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.utils.platform import resolve_device

DECAY_CLAMP = 4.0
_F32 = torch.float32


# ---------------------------------------------------------------------------
# init (the port's own seeded draws, with the reference's distributions)
# ---------------------------------------------------------------------------


def _const(shape, value, dtype, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=device)


def init_time_mix(cfg, n_layers: int, dtype, device, generator=None) -> dict:
    D, r = cfg.d_model, cfg.rwkv
    n, R = r.head_dim, r.lora_rank_mix
    H = D // n
    Ls = (n_layers,)
    mix_w2 = torch.randn(Ls + (5, R, D), generator=generator, device=device)
    return {
        "mu_base": _const(Ls + (D,), 0.5, dtype, device),
        "mix_w1": L.dense_init(Ls + (D, R * 5), dtype, device, generator),
        "mix_w2": mix_w2.div_(math.sqrt(R)).to(dtype),
        "mu": _const(Ls + (5, D), 0.5, dtype, device),
        "wr": L.dense_init(Ls + (D, D), dtype, device, generator),
        "wk": L.dense_init(Ls + (D, D), dtype, device, generator),
        "wv": L.dense_init(Ls + (D, D), dtype, device, generator),
        "wg": L.dense_init(Ls + (D, D), dtype, device, generator),
        "wo": L.dense_init(Ls + (D, D), dtype, device, generator),
        "w0": _const(Ls + (D,), 0.0, dtype, device),
        "decay_w1": L.dense_init(Ls + (D, r.lora_rank_decay), dtype, device,
                                 generator),
        "decay_w2": L.dense_init(Ls + (r.lora_rank_decay, D), dtype, device,
                                 generator),
        "bonus": _const(Ls + (H, n), 0.0, dtype, device),
        "gn": _const(Ls + (H, n), 1.0, dtype, device),
    }


def init_channel_mix(cfg, n_layers: int, dtype, device, generator=None
                     ) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    Ls = (n_layers,)
    return {
        "mu_k": _const(Ls + (D,), 0.5, dtype, device),
        "mu_r": _const(Ls + (D,), 0.5, dtype, device),
        "wk": L.dense_init(Ls + (D, F_), dtype, device, generator),
        "wv": L.dense_init(Ls + (F_, D), dtype, device, generator),
        "wr": L.dense_init(Ls + (D, D), dtype, device, generator),
    }


def init_params(cfg, device="cpu", generator: Optional[torch.Generator] = None
                ) -> dict:
    """Stacked parameters drawn from ``generator`` on ``device`` (the
    ``meta`` device gives shapes and dtypes without storage)."""
    dtype = getattr(torch, cfg.param_dtype)
    n, D = cfg.n_layers, cfg.d_model
    return {
        "embed": L.embed_init((cfg.padded_vocab, D), dtype, device, generator),
        "blocks": {
            "ln1": _const((n, D), 1.0, dtype, device),
            "ln2": _const((n, D), 1.0, dtype, device),
            "time": init_time_mix(cfg, n, dtype, device, generator),
            "chan": init_channel_mix(cfg, n, dtype, device, generator),
        },
        "ln_f": _const((D,), 1.0, dtype, device),
        "lm_head": L.dense_init((D, cfg.padded_vocab), dtype, device,
                                generator),
    }


# ---------------------------------------------------------------------------
# ddlerp token shift
# ---------------------------------------------------------------------------


def _ddlerp(p: dict, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent lerp producing the 5 mixed inputs (r, k, v, w, g).
    x, x_prev: (B, T, D). Returns a tuple of 5 tensors (B, T, D)."""
    dxx = x_prev - x
    base = x + dxx * p["mu_base"]
    lora = torch.tanh(base @ p["mix_w1"])  # (B, T, 5R)
    B, T, _ = lora.shape
    R = p["mix_w2"].shape[1]
    lora = lora.reshape(B, T, 5, R)
    off = torch.einsum("btfr,frd->btfd", lora, p["mix_w2"])  # (B, T, 5, D)
    mixed = x[:, :, None, :] + dxx[:, :, None, :] * (p["mu"] + off)
    return torch.unbind(mixed, dim=2)


def _decay_log(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel log-decay in (-DECAY_CLAMP, 0). xw: (B, T, D)."""
    lora = torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]
    return -DECAY_CLAMP * torch.sigmoid((p["w0"] + lora).to(_F32))


# ---------------------------------------------------------------------------
# wkv: chunkwise form (train/prefill) and the exact per-step recurrence
# ---------------------------------------------------------------------------


def wkv_chunked(r, k, v, log_w, bonus, state, chunk: int):
    """Chunkwise RWKV6 recurrence.

    r, k, v: (B, T, H, n); log_w: (B, T, H, n) (negative); bonus: (H, n);
    state: (B, H, n, n). T must be a multiple of ``chunk``.
    Returns (o (B, T, H, n) in r's dtype, final state in float32).
    """
    B, T, H, n = r.shape
    C = chunk
    NC = T // C
    # (B, NC, C, H, n) in float32
    rs, ks, vs, lw = (a.to(_F32).reshape(B, NC, C, H, n)
                      for a in (r, k, v, log_w))
    u = bonus.to(_F32)
    cum = torch.cumsum(lw, dim=2)  # inclusive per-channel, within a chunk
    last = cum[:, :, -1]  # (B, NC, H, n): each chunk's total log decay
    # q_t = r_t * exp(cum_{t-1});  kappa_s = k_s * exp(-cum_s)
    q = rs * torch.exp(cum - lw)
    kap = ks * torch.exp(-cum)
    # intra-chunk: strict-lower pairwise (q_t . kappa_s) v_s
    att = torch.einsum("bxchi,bxshi->bxhcs", q, kap)  # (B, NC, H, C, C)
    att = att * torch.tril(torch.ones((C, C), dtype=_F32, device=r.device),
                           -1)
    o_intra = torch.einsum("bxhcs,bxshj->bxchj", att, vs)
    # bonus (diagonal) term: (r_t . (u * k_t)) v_t
    diag = torch.sum(rs * (u * ks), dim=-1, keepdim=True)  # (B, NC, C, H, 1)
    # each chunk's own state term: sum_s diag(exp(cum_C - cum_s)) k_s v_s^T,
    # chunk-major so that each chunk's (B, H, n, n) slice is contiguous
    kv = torch.einsum("bxshi,bxshj->xbhij",
                      ks * torch.exp(last[:, :, None] - cum), vs)
    # the carry: the state entering each chunk, S' = diag(A) S + KV
    decay = torch.unbind(torch.exp(last).movedim(1, 0)[..., None])
    kvs = torch.unbind(kv)
    S = state.to(_F32)
    entering = []
    for c in range(NC):
        entering.append(S)
        S = torch.addcmul(kvs[c], decay[c], S)
    # inter-chunk: o_inter[t] = q_t @ S_entering
    o_inter = torch.einsum("bxchi,xbhij->bxchj", q, torch.stack(entering))
    o = o_inter + o_intra + diag * vs
    return o.reshape(B, T, H, n).to(r.dtype), S


def wkv_step(r, k, v, log_w, bonus, state):
    """Exact single-token recurrence (decode / oracle).
    r, k, v, log_w: (B, H, n); state: (B, H, n, n) float32."""
    rf, kf, vf = (a.to(_F32) for a in (r, k, v))
    u = bonus.to(_F32)
    kv = torch.einsum("bhi,bhj->bhij", kf, vf)
    o = torch.einsum("bhi,bhij->bhj", rf, state + u[None, :, :, None] * kv)
    w = torch.exp(log_w.to(_F32))
    state = w[..., None] * state + kv
    return o.to(r.dtype), state


def wkv_scan(r, k, v, log_w, bonus, state):
    """The per-step recurrence over T (the reference's pure-scan fallback
    for a sequence that is not a whole number of chunks).
    Returns (o (B, T, H, n), final state)."""
    S = state.to(_F32)
    outs = []
    for t in range(r.shape[1]):
        o, S = wkv_step(r[:, t], k[:, t], v[:, t], log_w[:, t], bonus, S)
        outs.append(o)
    return torch.stack(outs, dim=1), S


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _shifted(x: torch.Tensor, x_prev_last: torch.Tensor) -> torch.Tensor:
    """x delayed by one token, the previous segment's last token first."""
    return torch.cat([x_prev_last[:, None, :].to(x.dtype), x[:, :-1, :]],
                     dim=1)


def time_mix(p: dict, cfg, x, x_prev_last, state
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, T, D); x_prev_last: (B, D) last token of the previous
    segment; state: (B, H, n, n). Returns (out, new last token, new
    state)."""
    B, T, D = x.shape
    n = cfg.rwkv.head_dim
    H = D // n
    xr, xk, xv, xw, xg = _ddlerp(p, x, _shifted(x, x_prev_last))
    r = (xr @ p["wr"]).reshape(B, T, H, n)
    k = (xk @ p["wk"]).reshape(B, T, H, n)
    v = (xv @ p["wv"]).reshape(B, T, H, n)
    g = xg @ p["wg"]
    log_w = _decay_log(p, xw).reshape(B, T, H, n)
    chunk = cfg.rwkv.chunk_size
    if T % chunk != 0 or T < chunk:
        o, state = wkv_scan(r, k, v, log_w, p["bonus"], state)
    else:
        o, state = wkv_chunked(r, k, v, log_w, p["bonus"], state, chunk)
    o = L.groupnorm_heads(p["gn"], o).reshape(B, T, D)
    out = (o * F.silu(g)) @ p["wo"]
    return out, x[:, -1, :], state


def channel_mix(p: dict, cfg, x, x_prev_last
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    dxx = _shifted(x, x_prev_last) - x
    xk = x + dxx * p["mu_k"]
    xr = x + dxx * p["mu_r"]
    k = torch.square(torch.relu(xk @ p["wk"]))
    v = k @ p["wv"]
    return torch.sigmoid(xr @ p["wr"]) * v, x[:, -1, :]


def block_apply(cfg, p, x, st):
    """st: dict(time_shift (B, D), chan_shift (B, D), wkv (B, H, n, n))."""
    t_out, t_shift, wkv = time_mix(
        p["time"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
        st["time_shift"], st["wkv"])
    h = x + t_out
    c_out, c_shift = channel_mix(
        p["chan"], cfg, L.rmsnorm(p["ln2"], h, cfg.norm_eps),
        st["chan_shift"])
    return h + c_out, {"time_shift": t_shift, "chan_shift": c_shift,
                       "wkv": wkv}


# ---------------------------------------------------------------------------
# model-level forward
# ---------------------------------------------------------------------------


def init_state(cfg, batch: int, device="cuda") -> dict:
    """Each layer's zero state on ``device`` (the card unless the caller
    asks for the CPU): the two token shifts and the WKV state, in float32,
    and the decode position ``index``, a host int (the reference's ()
    int32)."""
    device = resolve_device(device)
    D = cfg.d_model
    n = cfg.rwkv.head_dim
    H = D // n
    L_ = cfg.n_layers
    return {
        "time_shift": torch.zeros((L_, batch, D), dtype=_F32, device=device),
        "chan_shift": torch.zeros((L_, batch, D), dtype=_F32, device=device),
        "wkv": torch.zeros((L_, batch, H, n, n), dtype=_F32, device=device),
        "index": 0,
    }


def forward(params: dict, cfg, tokens: torch.Tensor, prefix_embeds=None,
            window=None, last_only: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, T) -> (logits (B, T, V_padded), aux_loss ()). Each layer
    starts from the zero state of ``init_state``; no RWKV config has
    prefix embeddings. ``last_only``: the final position's logits only,
    (B, 1, V_padded)."""
    del prefix_embeds, window
    B, T = tokens.shape
    x = params["embed"][tokens].to(getattr(torch, cfg.compute_dtype))
    st = init_state(cfg, B, tokens.device)
    for i, blk in enumerate(L.unstack_layers(params["blocks"],
                                             cfg.n_layers)):
        x, _ = block_apply(cfg, blk, x, {
            "time_shift": st["time_shift"][i],
            "chan_shift": st["chan_shift"][i], "wkv": st["wkv"][i]})
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    logits = x @ params["lm_head"].to(x.dtype)
    return logits, torch.zeros((), dtype=_F32, device=x.device)


def decode_step(params: dict, cfg, cache: dict, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, dict]:
    """tokens: (B,) -> (logits (B, V_padded), cache): one token through
    every layer's ``block_apply`` from its carried state, O(1) in the
    sequence length. Each layer's new token shifts and WKV state are
    written back into the cache's float32 tensors in place (the
    reference's ``astype(float32)``); the returned cache holds them and
    ``index`` + 1."""
    x = params["embed"][tokens][:, None, :].to(
        getattr(torch, cfg.compute_dtype))  # (B, 1, D)
    for i, blk in enumerate(L.unstack_layers(params["blocks"],
                                             cfg.n_layers)):
        x, st = block_apply(cfg, blk, x, {
            "time_shift": cache["time_shift"][i],
            "chan_shift": cache["chan_shift"][i], "wkv": cache["wkv"][i]})
        for name in ("time_shift", "chan_shift", "wkv"):
            cache[name][i].copy_(st[name])
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = x[:, 0] @ params["lm_head"].to(x.dtype)
    return logits, {**cache, "index": cache["index"] + 1}
