"""InternVL2-26B — InternViT vision encoder + InternLM2-20B LM.

Source: arXiv:2404.16821. LM backbone (what we implement): 48L,
d_model=6144, 48 heads (kv=8), d_ff=16384, vocab=92553. The InternViT
encoder + MLP projector are a STUB: ``n_prefix_embeddings`` image-patch
embeddings come precomputed in a batch's ``prefix_embeds``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2-26b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=92553,
        n_prefix_embeddings=256,  # stub ViT patch embeddings per image
        source="arXiv:2404.16821",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=512, vocab_pad_multiple=16, n_prefix_embeddings=8,
    )
