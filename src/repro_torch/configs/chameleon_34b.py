"""Chameleon-34B — early-fusion VLM backbone over VQ image tokens.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  The VQ-VAE image
tokenizer is a STUB per assignment: ``input_specs`` provides precomputed
token/patch embeddings; the backbone is the deliverable.
[arXiv:2405.09818; unverified]
"""
from repro_torch.configs.base import ArchConfig, register


@register("chameleon-34b")
def chameleon_34b() -> ArchConfig:
    return ArchConfig(
        name="chameleon-34b",
        family="dense",
        modality="vision",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=8192 // 64,        # 128
        d_ff=22_016,
        vocab_size=65_536,
        act="silu",
        rope_theta=10_000.0,
        source="arXiv:2405.09818; unverified",
    )
