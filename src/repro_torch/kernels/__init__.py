"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``tick_sim`` — the fused batched co-simulation tick loop; ``flash_attention``
(prefill), ``flash_decode`` (ring-cache decode, split + combine) and
``fused_mlp`` (RMSNorm + gated-MLP first half) — the LLM serving kernels,
with the reference's signatures in ``ops``.  CUDA C++ for sm_90a under
``csrc/``, built at first use by ``build``.
"""
