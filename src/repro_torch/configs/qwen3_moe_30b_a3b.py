"""Qwen3-30B-A3B — MoE decoder, 128 experts top-8, GQA + qk_norm.

Source: hf:Qwen/Qwen3-30B-A3B. 48L, d_model=2048, 32 heads (kv=4,
head_dim=128), per-expert d_ff=768, vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        head_dim=128, d_ff=768, vocab_size=151936,
        qk_norm=True, rope_theta=1e6,
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=768),
        source="hf:Qwen/Qwen3-30B-A3B",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=128),
    )
