"""Phi-3-medium-14B — RoPE SwiGLU GQA dense transformer.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
[arXiv:2404.14219; unverified]
"""
from repro_torch.configs.base import ArchConfig, register


@register("phi3-medium-14b")
def phi3_medium_14b() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        head_dim=5120 // 40,        # 128
        d_ff=17_920,
        vocab_size=100_352,
        act="silu",
        rope_theta=10_000.0,
        source="arXiv:2404.14219; unverified",
    )
