"""MusicGen-medium — decoder-only transformer over EnCodec tokens.

Source: arXiv:2306.05284. 48L, d_model=1536, 24 heads (MHA), d_ff=6144,
vocab=2048 (EnCodec codebook). The EnCodec conv frontend is a STUB:
``n_prefix_embeddings`` conditioning frames come as precomputed
embeddings in a batch's ``prefix_embeds``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="musicgen-medium", family="dense",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
        d_ff=6144, vocab_size=2048, vocab_pad_multiple=64,
        n_prefix_embeddings=256,  # stub conditioning frames
        source="arXiv:2306.05284",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab_size=512, vocab_pad_multiple=16, n_prefix_embeddings=8,
    )
