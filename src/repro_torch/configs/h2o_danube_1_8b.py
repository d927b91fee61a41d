"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA.
[arXiv:2401.16818; hf]
"""
from repro_torch.configs.base import ArchConfig, register


@register("h2o-danube-1.8b")
def h2o_danube_1_8b() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=2560 // 32,        # 80
        d_ff=6912,
        vocab_size=32_000,
        act="silu",
        rope_theta=10_000.0,
        sliding_window=4_096,        # mistral-style SWA -> long_500k runnable
        source="arXiv:2401.16818; hf",
    )
