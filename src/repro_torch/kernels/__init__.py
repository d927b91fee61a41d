"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``tick_sim`` — the fused batched co-simulation tick loop; ``flash_attention``
(prefill), ``flash_decode`` (ring-cache decode, split + combine),
``fused_mlp`` (RMSNorm + gated-MLP first half) and ``ssd_scan`` (the
Mamba-2 chunked scan) — the LLM kernels, with the reference's signatures
and autograd Functions for training in ``ops`` (backward: the autograd of
the oracles in ``ref``).  CUDA C++ for sm_90a under ``csrc/``, built at
first use by ``build``.
"""
