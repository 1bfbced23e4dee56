"""Granite-3.0-3B-A800M — MoE decoder, 40 experts top-8.

Source: hf:ibm-granite/granite-3.0-1b-a400m-base (family card; 3b-a800m
point). 32L, d_model=1536, 24 heads (kv=8), per-expert d_ff=512,
vocab=49155.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab_size=49155,
        moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, vocab_pad_multiple=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=128),
    )
