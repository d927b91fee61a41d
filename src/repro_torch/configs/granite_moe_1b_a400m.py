"""IBM Granite-3.0-1B-A400M — 32-expert top-8 MoE.

24L d_model=1024 16H (GQA kv=8) d_ff(expert)=512 vocab=49155, MoE 32e top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ArchConfig, register


@register("granite-moe-1b-a400m")
def granite_moe_1b_a400m() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=1024 // 16,        # 64
        d_ff=512,                    # expert width (all layers MoE)
        vocab_size=49_155,
        act="silu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        n_experts=32,
        n_shared_experts=0,
        top_k=8,
        d_ff_expert=512,
        n_dense_layers=0,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    )
