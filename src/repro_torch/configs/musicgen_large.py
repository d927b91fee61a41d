"""MusicGen-large — decoder-only transformer over EnCodec audio tokens.

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048.  The EnCodec frontend
is a STUB per assignment: ``input_specs`` provides precomputed frame
embeddings; the backbone is the deliverable.
[arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ArchConfig, register


@register("musicgen-large")
def musicgen_large() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large",
        family="dense",
        modality="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=2048 // 32,        # 64
        d_ff=8192,
        vocab_size=2048,
        act="gelu",
        rope_theta=10_000.0,
        source="arXiv:2306.05284; hf",
    )
