"""Yi-9B — llama-architecture dense decoder with GQA.

Source: arXiv:2403.04652. 48L, d_model=4096, 32 heads, kv=4,
d_ff=11008, vocab=64000.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="yi-9b", family="dense",
        n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab_size=64000, rope_theta=5e6,
        source="arXiv:2403.04652",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=512, vocab_pad_multiple=16,
    )
