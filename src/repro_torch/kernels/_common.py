"""What the LLM kernel wrappers share: dtype codes, device dispatch, the
checks made before a launch, and what a FLOP counter asks of the wrappers
and of the model's loops (``refuse_counting``, ``repeat``, ``unfolded``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_card(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel), False
    on the CPU (run the plain version); anything else raises."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {dev}")


def refuse_grad(name: str, *tensors: torch.Tensor,
                backward: bool = True) -> None:
    """Raise when grad mode is on and a CUDA input requires grad: the raw
    wrappers write their output through a pointer, so autograd would never
    see the launch and the result would come back cut off from the graph.
    The autograd Functions of ``repro_torch.kernels.ops`` launch the same
    kernels with a backward; a kernel without one (``backward=False``:
    the decode and the tick loop) names its plain version instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        fix = (f"call repro_torch.kernels.ops.{name}, whose backward runs "
               f"the oracle's autograd" if backward else
               f"the kernel has no backward: differentiate {name}_plain")
        raise RuntimeError(
            f"{name}: an input on the card requires grad, and the kernel's "
            f"output would carry no gradient; {fix}")


def check(name: str, t: torch.Tensor, ndim: int,
          dtypes: Sequence[torch.dtype] = tuple(DTYPE_CODES)) -> int:
    """Raise unless ``t`` is contiguous, ``ndim``-dimensional and of one of
    ``dtypes``; returns its dtype code."""
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {tuple(dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return DTYPE_CODES.get(t.dtype, -1)


def positions(p: torch.Tensor, shape) -> torch.Tensor:
    """Positions as the kernels read them: contiguous int32 of ``shape``."""
    if tuple(p.shape) != tuple(shape):
        raise ValueError(f"positions of shape {tuple(p.shape)}, expected "
                         f"{tuple(shape)}")
    return p.to(torch.int32).contiguous()


def aligned16(*tensors: torch.Tensor) -> bool:
    """True when every tensor's data starts on a 16-byte boundary (what a
    TMA load or a 16-byte vector load of it needs)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


_SM_COUNT = {}  # repro: noqa[TPR003] one entry per CUDA device index of the process, at most torch.cuda.device_count()


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (read once per device)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# FLOP counting (``repro_torch.launch.costing``): what the wrappers and the
# model's loops ask of an active counter
# ---------------------------------------------------------------------------

def active_counter():
    """The innermost FLOP counter active in this thread, or ``None``.  A
    counter is active while its dispatch mode is on the stack, which is the
    thread's own (the autograd engine carries it into the backward), so a
    counter in one thread changes nothing that another thread computes."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in reversed(_get_current_dispatch_mode_stack()):
        counter = getattr(mode, "flop_counter", None)
        if counter is not None:
            return counter
    return None


def refuse_counting(name: str) -> None:
    """Raise when a FLOP counter is active: a kernel is launched through
    ``ctypes``, which dispatch never sees, so its work would drop out of
    the count without a word."""
    if active_counter() is not None:
        raise RuntimeError(
            f"{name}: a kernel launch while counting FLOPs; dispatch does "
            f"not see it, so its work would be missing from the count.  "
            f"Count on abstract inputs (meta, or fakes on the CPU), where "
            f"the kernel's plain version runs")


def repeat(n: int, key=None, fold: bool = True):
    """``range(n)`` for a loop whose iterations repeat one body (the
    reference's ``lax.scan``).  Under a folding FLOP counter only the first
    index of each class ``key(i)`` runs (all one class without ``key``), and
    its work, backward and recompute included, counts once per index of
    its class.  ``fold=False`` keeps every iteration: a loop whose carry
    starts as a constant, where the first iteration's backward is not the
    others'."""
    c = active_counter()
    if c is None or not c.fold or not fold or n <= 1:
        return range(n)
    return c.repeat(n, key)


def unfolded(outs: list, n: Optional[int] = None) -> list:
    """The per-iteration outputs of a :func:`repeat` loop, ``n`` long (the
    list's length without ``n``): a folding counter leaves the iterations
    it did not run as ``None`` or missing, and these get an uncounted empty
    tensor of the computed ones' shape.  Without a counter ``outs`` as it
    is."""
    c = active_counter()
    if c is None or not c.fold:
        return outs
    return c.unfolded(outs, n)
