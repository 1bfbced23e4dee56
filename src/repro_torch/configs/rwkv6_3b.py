"""RWKV-6 "Finch" 3B — attention-free, data-dependent decay.

Source: arXiv:2404.05892 (Eagle and Finch). 32L, d_model=2560,
d_ff=8960, vocab=65536, head_dim=64 (40 wkv heads).
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="rwkv6-3b", family="rwkv",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=8960, vocab_size=65536,
        rwkv=RWKVConfig(head_dim=64, lora_rank_decay=64, lora_rank_mix=32,
                        chunk_size=16),
        source="arXiv:2404.05892",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab_size=512, vocab_pad_multiple=16,
        rwkv=RWKVConfig(head_dim=64, lora_rank_decay=8, lora_rank_mix=4,
                        chunk_size=16),
    )
