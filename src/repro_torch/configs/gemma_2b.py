"""Gemma-2B — GeGLU, head_dim=256, MQA (kv=1), huge vocab, tied embeddings.

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.
[arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ArchConfig, register


@register("gemma-2b")
def gemma_2b() -> ArchConfig:
    return ArchConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,               # MQA
        head_dim=256,               # 8 * 256 = 2048
        d_ff=16_384,
        vocab_size=256_000,
        act="gelu",                  # GeGLU
        rope_theta=10_000.0,
        tie_embeddings=True,
        source="arXiv:2403.08295; hf",
    )
