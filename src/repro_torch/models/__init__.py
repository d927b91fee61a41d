"""The LLM model stack of the port: parameter specs (``params``), layers
(``layers``: norms, RoPE, GQA and MLA attention, gated MLP), the Mamba-2
mixer (``mamba2``), the mixture-of-experts FFN (``moe``) and the decoder
LM (``transformer``): the dense, ssm, hybrid and moe families."""
