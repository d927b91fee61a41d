"""The LLM model stack of the port: parameter specs (``params``), layers
(``layers``: norms, RoPE, GQA attention, gated MLP) and the decoder LM
(``transformer``).  The dense GQA family is ported; the others raise
``NotImplementedError`` naming their ROADMAP item."""
