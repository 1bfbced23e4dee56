"""Model bundle: family dispatch, init, forward, loss, prefill and decode
(port of ``repro.models.model`` for the dense, MoE, RWKV and hybrid
griffin families).

    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    loss, metrics = model.loss(params, batch)
    shapes = model.param_shapes()          # meta tensors, no storage
    logits = model.prefill_logits(params, {"tokens": tokens})
    cache = model.init_cache(batch, max_len, device="cuda")
    logits, cache = model.decode_step(params, cache, tokens)   # (B,)

A decode step updates the cache in place where the reference donates it
and returns the cache to use next; its ``index`` is a host int.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import griffin, rwkv, transformer
from repro_torch.utils.platform import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map


def _xent(cfg, logits: torch.Tensor, labels: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked cross-entropy. labels < 0 are ignored (prefix/pad positions).

    Padded-vocab logits are excluded from the partition function; the
    log-sum-exp runs in float32."""
    V = cfg.vocab_size
    Vp = logits.shape[-1]
    if Vp > V:
        pad_mask = torch.arange(Vp, device=logits.device) < V
        logits = torch.where(pad_mask, logits, -1e30)
    lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
    labels = labels.to(torch.int64)
    safe_labels = torch.clamp(labels, min=0)
    ll = torch.gather(logits, -1, safe_labels[..., None])[..., 0]
    per_tok = lse - ll.to(torch.float32)
    mask = (labels >= 0).to(torch.float32)
    n = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(per_tok * mask) / n, n


_FAMILIES = {
    "dense": transformer,
    "moe": transformer,
    "rwkv": rwkv,
    "hybrid": griffin,
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def _mod(self):
        return _FAMILIES[self.cfg.family]

    def _cast(self, params):
        """Float params in the compute dtype (the float32 masters stay with
        the optimizer; the forward runs in ``cfg.compute_dtype``)."""
        dt = getattr(torch, self.cfg.compute_dtype)
        return tree_map(lambda p: p.to(dt) if p.is_floating_point() else p,
                        params)

    # -- parameters ---------------------------------------------------------

    def init(self, seed: int = 0, device="cuda") -> dict:
        """The port's own seeded init (``torch.Generator`` on ``device``;
        CUDA unless the caller asks for the CPU)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return self._mod.init_params(self.cfg, device=device, generator=gen)

    def param_shapes(self) -> dict:
        """Parameter tree on the ``meta`` device: shapes and dtypes only."""
        return self._mod.init_params(self.cfg, device="meta")

    # -- training path --------------------------------------------------------

    def forward(self, params, batch, window: Optional[int] = None):
        return self._mod.forward(
            self._cast(params), self.cfg, batch["tokens"],
            prefix_embeds=batch.get("prefix_embeds"), window=window)

    def prefill_logits(self, params, batch) -> torch.Tensor:
        """Last-position logits (B, V_padded) only: the LM head runs on
        the final position (no (B, S, V) logits)."""
        logits, _ = self._mod.forward(
            self._cast(params), self.cfg, batch["tokens"],
            prefix_embeds=batch.get("prefix_embeds"), last_only=True)
        return logits[:, -1]

    def loss(self, params, batch) -> Tuple[torch.Tensor, dict]:
        logits, aux = self.forward(params, batch)
        xent, n_tok = _xent(self.cfg, logits, batch["labels"])
        return xent + aux, {"xent": xent, "aux": aux, "n_tokens": n_tok}

    # -- decode path ----------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda"):
        """The family's zero decode cache on ``device`` (the card unless
        the caller asks for the CPU): a KV cache in ``dtype`` (dense, MoE),
        the float32 recurrent state (RWKV: ``dtype`` unused, as in the
        reference), or griffin's per-layer list; each with its ``index``."""
        cfg = self.cfg
        device = resolve_device(device)
        if cfg.family in ("dense", "moe"):
            return transformer.init_cache(cfg, batch, max_len, dtype, device)
        if cfg.family == "rwkv":
            return rwkv.init_state(cfg, batch, device)
        if cfg.family == "hybrid":
            return {"layers": griffin.init_state(cfg, batch, max_len, dtype,
                                                 device),
                    "index": 0}
        raise ValueError(cfg.family)

    def cache_shapes(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """The cache on the ``meta`` device: shapes and dtypes only."""
        return self.init_cache(batch, max_len, dtype, device="meta")

    def decode_step(self, params, cache, tokens):
        """tokens (B,) -> (logits (B, V_padded), cache). The float32 params
        are cast to the compute dtype on every call, as the reference's
        ``_cast`` does inside its step."""
        return self._mod.decode_step(self._cast(params), self.cfg, cache,
                                     tokens)

    def n_params(self) -> int:
        return sum(p.numel() for p in tree_leaves(self.param_shapes()))

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k of n_experts count)."""
        cfg = self.cfg
        total = self.n_params()
        if cfg.moe is None:
            return total
        moe = self.param_shapes()["blocks"]["moe"]
        expert_total = sum(moe[name].numel()
                           for name in ("w_gate", "w_up", "w_down"))
        active_frac = cfg.moe.top_k / cfg.moe.n_experts
        return int(total - expert_total + expert_total * active_frac)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; options: "
                         f"{sorted(_FAMILIES)}")
    return Model(cfg)
