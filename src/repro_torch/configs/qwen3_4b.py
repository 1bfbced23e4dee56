"""Qwen3-4B — dense decoder with qk_norm and GQA.

Source: hf:Qwen/Qwen3-8B (family card; 4B point). 36L, d_model=2560,
32 heads (kv=8, head_dim=128), d_ff=9728, vocab=151936.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=9728, vocab_size=151936,
        qk_norm=True, rope_theta=1e6,
        source="hf:Qwen/Qwen3-8B",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, vocab_pad_multiple=16,
    )
