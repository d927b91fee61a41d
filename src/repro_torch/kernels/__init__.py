"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``tick_sim`` — the fused batched co-simulation tick loop (CUDA C++ for
sm_90a, ``csrc/tick_sim.cu``), built at first use by ``build``.
"""
