"""IBM Granite-8B (code) — llama-architecture dense transformer.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
[arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ArchConfig, register


@register("granite-8b")
def granite_8b() -> ArchConfig:
    return ArchConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=4096 // 32,        # 128
        d_ff=14_336,
        vocab_size=49_152,
        act="silu",
        rope_theta=10_000.0,
        source="arXiv:2405.04324; hf",
    )
