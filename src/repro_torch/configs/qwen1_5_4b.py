"""Qwen1.5-4B — dense decoder with QKV bias.

Source: hf:Qwen/Qwen1.5-0.5B (family card; 4B point). 40L,
d_model=2560, 20 heads (GQA kv=20 i.e. MHA), d_ff=6912, vocab=151936.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
        d_ff=6912, vocab_size=151936,
        qkv_bias=True, rope_theta=1e6,
        source="hf:Qwen/Qwen1.5-0.5B",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab_size=512, vocab_pad_multiple=16,
    )
