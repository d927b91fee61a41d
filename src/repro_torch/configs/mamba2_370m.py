"""Mamba-2 370M — attention-free SSD (state-space duality).

48L d_model=1024, d_state=128, expand=2 (d_inner=2048, headdim=64 -> 32 heads),
vocab=50280.
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig, register


@register("mamba2-370m")
def mamba2_370m() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        attn_type="none",
        tie_embeddings=True,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_conv=4,
        ssm_ngroups=1,
        ssm_chunk=256,
        source="arXiv:2405.21060; unverified",
    )
