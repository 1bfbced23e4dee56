"""RecurrentGemma-9B — Griffin: RG-LRU recurrent blocks + local
attention, pattern 1 attention per 2 recurrent layers.

Source: arXiv:2402.19427. 38L, d_model=4096, 16 heads (kv=1 => MQA,
head_dim=256), d_ff=12288, vocab=256000, window=2048.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab_size=256000,
        hybrid=HybridConfig(pattern=("rec", "rec", "attn"),
                            lru_width=4096, conv_width=4,
                            attn_window=2048),
        source="arXiv:2402.19427",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, d_ff=512,
        vocab_size=512, vocab_pad_multiple=16,
        hybrid=HybridConfig(pattern=("rec", "rec", "attn"),
                            lru_width=256, conv_width=4,
                            attn_window=64),
    )
