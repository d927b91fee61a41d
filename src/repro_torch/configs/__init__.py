"""Configurations of the port.

``vespa_soc`` is the paper's own 4x4 SoC.  Every LLM architecture of the
reference (dense GQA, the attention-free ``ssm`` family, the ``hybrid``
family, the GQA ``moe`` family and the MLA ``moe`` deepseek-v2-lite-16b)
registers itself when this package is imported, as in the reference.
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
    deepseek_v2_lite_16b,
)

# The architectures the dry run covers (the reference's list).
ASSIGNED_ARCHS = [
    "h2o-danube-1.8b",
    "phi3-medium-14b",
    "granite-8b",
    "gemma-2b",
    "deepseek-v2-lite-16b",
    "granite-moe-1b-a400m",
    "mamba2-370m",
    "zamba2-7b",
    "chameleon-34b",
    "musicgen-large",
]
