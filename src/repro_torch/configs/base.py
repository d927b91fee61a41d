"""Architecture & shape configuration of the port's LLM stack.

A copy of the reference's ``configs/base.py`` (pure Python, no JAX):
every architecture is a frozen :class:`ArchConfig`, input shapes are
:class:`ShapeConfig`, a registry maps ``--arch <id>`` strings to configs and
``reduced()`` gives a CPU-sized config of the same family.

Only architectures the port can run are registered (dense GQA, the
attention-free ``ssm`` family, the ``hybrid`` family with its GQA shared
tile and the ``moe`` family with GQA attention).  :func:`get_config` of a known architecture whose family or
attention type is not ported yet raises ``NotImplementedError`` naming its
ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    """A complete decoder-LM architecture description.

    Families: ``dense`` (pure transformer), ``moe`` (mixture-of-experts FFN),
    ``ssm`` (attention-free Mamba-2), ``hybrid`` (Mamba-2 backbone + shared
    attention tile, Zamba-2 style).
    """

    name: str
    family: str                     # dense | moe | ssm | hybrid
    modality: str = "text"          # text | vision | audio

    # Transformer core ------------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    act: str = "silu"               # silu -> SwiGLU, gelu -> GeGLU
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # 0 = full attention
    tie_embeddings: bool = False

    # Attention variant -----------------------------------------------------
    attn_type: str = "gqa"          # gqa | mla | none
    # MLA (DeepSeek-V2) params
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 0

    # MoE -------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0         # leading layers that stay dense (DeepSeek)
    capacity_factor: float = 1.25

    # SSM (Mamba-2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # Hybrid (Zamba-2) ------------------------------------------------------
    shared_attn_every: int = 0      # shared attention block every N ssm blocks

    dtype: str = "bfloat16"
    source: str = ""                # provenance [arXiv/hf; tier]

    # ------------------------------------------------------------------ utils
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode path exists (SSM state or sliding window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def n_params(self) -> int:
        """Analytic parameter count (embedding + per-layer), for 6ND maths."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe"):
            per_layer += self._attn_params()
            per_layer += self._ffn_params()
            per_layer += 2 * d  # two RMSNorm scales
        elif self.family == "ssm":
            per_layer += self._ssm_params() + d
        elif self.family == "hybrid":
            per_layer += self._ssm_params() + d
        total = emb + L * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            # one shared attention+MLP tile reused across the depth
            total += self._attn_params() + 3 * self.d_model * self.d_ff + 2 * d
        return total

    def n_active_params(self) -> int:
        """Active (per-token) parameters — differs for MoE."""
        if self.family != "moe":
            return self.n_params()
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = self._attn_params() + 2 * d
        active_experts = self.top_k + self.n_shared_experts
        moe_ffn = 3 * d * self.d_ff_expert * active_experts
        dense_ffn = 3 * d * self.d_ff if self.d_ff else moe_ffn
        n_moe = L - self.n_dense_layers
        return emb + L * per_layer + n_moe * moe_ffn + self.n_dense_layers * dense_ffn

    def _attn_params(self) -> int:
        d, H, KV, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        if self.attn_type == "mla":
            rope, nope, vh = self.qk_rope_dim, self.qk_nope_dim, self.v_head_dim
            q = d * H * (nope + rope)
            kv_down = d * (self.kv_lora_rank + rope)
            kv_up = self.kv_lora_rank * H * (nope + vh)
            o = H * vh * d
            return q + kv_down + kv_up + o
        if self.attn_type == "none":
            return 0
        return d * H * hd + 2 * d * KV * hd + H * hd * d

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.family == "moe":
            n_moe = self.n_layers - self.n_dense_layers
            per = 3 * d * self.d_ff_expert * (self.n_experts + self.n_shared_experts)
            per += d * self.n_experts  # router
            dense = 3 * d * self.d_ff
            # average per layer (approximation used only for reporting)
            return (n_moe * per + self.n_dense_layers * dense) // max(self.n_layers, 1)
        return 3 * d * self.d_ff

    def _ssm_params(self) -> int:
        d, di, st = self.d_model, self.d_inner, self.ssm_state
        nh, g = self.n_ssm_heads, self.ssm_ngroups
        in_proj = d * (2 * di + 2 * g * st + nh)
        conv = self.ssm_conv * (di + 2 * g * st)
        out = di * d
        return in_proj + conv + nh + nh + out  # + A_log + D

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw: Dict = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            d_ff=128,
            vocab_size=256,
        )
        if self.attn_type != "none":
            kw.update(n_heads=4, n_kv_heads=min(self.n_kv_heads, 2) or 2, head_dim=16)
        if self.attn_type == "mla":
            kw.update(kv_lora_rank=32, qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16,
                      n_heads=4, head_dim=16)
        if self.family == "moe":
            kw.update(n_experts=4, top_k=2, d_ff_expert=64,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      n_dense_layers=min(self.n_dense_layers, 1))
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
        if self.family == "hybrid":
            kw.update(shared_attn_every=2, n_layers=4, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=128)
        if self.sliding_window:
            kw.update(sliding_window=32)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


LM_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ArchConfig) -> Dict[str, ShapeConfig]:
    """The shape cells applicable to an architecture.

    ``long_500k`` needs a sub-quadratic decode path (SSM state or SWA window);
    pure full-attention archs skip it (recorded in DESIGN.md).
    """
    out = dict(LM_SHAPES)
    if not cfg.supports_long_context:
        out.pop("long_500k")
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}   # one entry per @register


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


# Architectures of the reference the port cannot run yet: (family, attn_type).
UNPORTED: Dict[str, Tuple[str, str]] = {
    "deepseek-v2-lite-16b": ("moe", "mla"),
}

_WAITS = {
    "mla": "MLA attention is not ported yet (ROADMAP queue A item 10.3)",
}


def _reason(name: str, family: str, attn_type: str) -> Optional[str]:
    if family == "ssm" and attn_type == "none":
        return None
    if family not in ("dense", "moe", "ssm", "hybrid"):
        return f"{name}: family {family!r}: {_WAITS.get(family, 'not ported')}"
    if attn_type != "gqa":
        return (f"{name}: attn_type {attn_type!r}: "
                f"{_WAITS.get(attn_type, 'not ported')}")
    return None


def not_ported(cfg: ArchConfig) -> Optional[str]:
    """Why the port cannot run ``cfg`` (``None`` when it can)."""
    return _reason(cfg.name, cfg.family, cfg.attn_type)


def get_config(name: str) -> ArchConfig:
    if name in UNPORTED:
        raise NotImplementedError(_reason(name, *UNPORTED[name]))
    if name not in _REGISTRY:
        # import side-effect registration
        from repro_torch import configs as _c  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> List[str]:
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)
