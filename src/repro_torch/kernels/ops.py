"""Public entry points of the LLM kernels, with the reference's signatures
(``repro/kernels/ops.py``), forward only.  Each runs its CUDA kernel on CUDA
tensors and its plain PyTorch version on CPU tensors.  The backward passes
(``torch.autograd.Function`` through the plain versions, as the reference's
``custom_vjp`` goes through its oracles) come with the training slice
(ROADMAP queue A item 11)."""
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.flash_decode import flash_decode  # noqa: F401
from repro_torch.kernels.fused_mlp import fused_rmsnorm_mlp  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401
