"""Zamba2-7B — Mamba-2 backbone with shared attention blocks (hybrid).

81 Mamba-2 layers d_model=3584 ssm_state=64, a *shared* transformer block
(32H MHA kv=32, d_ff=14336) applied every 6 backbone layers.  vocab=32000.
[arXiv:2411.15242; unverified]
"""
from repro_torch.configs.base import ArchConfig, register


@register("zamba2-7b")
def zamba2_7b() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=3584 // 32,        # 112
        d_ff=14_336,
        vocab_size=32_000,
        act="gelu",
        rope_theta=10_000.0,
        ssm_state=64,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_conv=4,
        ssm_ngroups=1,
        ssm_chunk=256,
        shared_attn_every=6,
        source="arXiv:2411.15242; unverified",
    )
