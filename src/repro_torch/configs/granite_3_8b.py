"""Granite-3.0-8B — dense decoder with GQA.

Source: hf:ibm-granite/granite-3.0-2b-base (family card; 8B point).
40L, d_model=4096, 32 heads (kv=8), d_ff=12800, vocab=49155.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-3-8b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12800, vocab_size=49155, rope_theta=1e4,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=512, vocab_pad_multiple=16,
    )
