"""DeepSeek-V2-Lite (16B, 2.4B active) — MLA + fine-grained MoE.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400,
MLA kv_lora_rank=512 (qk_rope=64, qk_nope=128, v_head=128),
MoE: 64 routed experts top-6 + 2 shared, first layer dense (d_ff=10944).
[arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import ArchConfig, register


@register("deepseek-v2-lite-16b")
def deepseek_v2_lite_16b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=10_944,                 # dense (first) layer FFN width
        vocab_size=102_400,
        act="silu",
        rope_theta=10_000.0,
        attn_type="mla",
        kv_lora_rank=512,
        qk_rope_dim=64,
        qk_nope_dim=128,
        v_head_dim=128,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        d_ff_expert=1408,
        n_dense_layers=1,
        source="arXiv:2405.04434; hf",
    )
