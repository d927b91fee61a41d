"""Configurations of the port.

``vespa_soc`` is the paper's own 4x4 SoC.  The LLM architectures the port
can run (dense GQA, the attention-free ``ssm`` family, the ``hybrid``
family and the GQA ``moe`` family) register themselves when this package
is imported, as in the reference; ``base.UNPORTED`` lists the ones that
wait.
"""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    ShapeConfig,
    LM_SHAPES,
    shapes_for,
    get_config,
    list_configs,
    not_ported,
    register,
)

from repro_torch.configs import (  # noqa: F401
    h2o_danube_1_8b,
    phi3_medium_14b,
    granite_8b,
    gemma_2b,
    chameleon_34b,
    musicgen_large,
    mamba2_370m,
    zamba2_7b,
    granite_moe_1b_a400m,
)
