"""Mamba-2 SSD chunked scan: wrapper, plain version, launch count.

``ssd_scan`` replaces the Pallas kernel of the reference,
``repro/kernels/ssd_scan.py`` (``_ssd_kernel`` / ``ssd_scan_pallas``).  On
CUDA tensors it launches the kernels of ``csrc/ssd_scan.cu`` (chunk
states, ``C B^T`` per chunk, the serial state pass, chunk outputs; see its
source note), the set chosen by :func:`_variant` from shape and alignment
alone, or raises (also when an input requires grad with grad mode on: the
output would carry no gradient, so training goes through
``kernels.ops.ssd_scan``); on CPU tensors it runs :func:`ssd_scan_plain`.
``ssd_scan.launches`` counts calls that launched, one per call (each call is
three or four kernels in a row), and ``ssd_scan.last_variant`` names the set
of the latest one.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._common import aligned16, check, on_card, \
    refuse_counting, refuse_grad, repeat, stream_of, unfolded

MAX_CHUNK = 256        # Q, tokens of one chunk (the kernels' shared memory)
MAX_STATE = 128        # st, the state width
MAX_HEAD_DIM = 64      # hd, the head dim
# The kernel sets, by the code csrc/ssd_scan.cu takes.
VARIANTS = {"cuda_cores": 0, "tf32x3": 1}


def _variant(hd: int, st: int, aligned: bool) -> str:
    """The kernel set for these operands: ``tf32x3`` (products on tensor
    cores in 3xTF32, 16-byte ``cp.async`` loads) when hd and st are
    multiples of 4 and xs, Bm and Cm are 16-byte aligned; ``cuda_cores``
    (float32 CUDA cores, any layout) otherwise."""
    if hd % 4 == 0 and st % 4 == 0 and aligned:
        return "tf32x3"
    return "cuda_cores"


def chunk_len(L: int, chunk: int) -> int:
    """The chunk length ``Q = min(chunk, L)``; ``L`` must be a multiple of
    it (the reference asserts the same)."""
    if chunk < 1 or L < 1:
        raise ValueError(f"chunk ({chunk}) and sequence length ({L}) must "
                         f"be >= 1")
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk length {Q}; pad with dt = 0 first")
    return Q


def chunk_cumsum(log_a: torch.Tensor, Q: int) -> torch.Tensor:
    """Cumulative sum of ``log_a`` (B, L, nh) within each chunk of ``Q``
    tokens (the ``la`` of the reference)."""
    Bb, L, nh = log_a.shape
    return torch.cumsum(log_a.reshape(Bb, L // Q, Q, nh), dim=2).reshape(
        Bb, L, nh)


def ssd_chunks_plain(xs, dt, la, Bm, Cm, D, Q: int):
    """The chunked SSD given the within-chunk cumulative log decay ``la``
    (B, L, nh): the reference's ``ssd_scan_ref`` from its ``la`` on, op for
    op (intra-chunk quadratic term masked by a select, chunk summary states,
    the inter-chunk recurrence as a loop over chunks, the skip term)."""
    Bb, L, nh, hd = xs.shape
    st = Bm.shape[-1]
    nc = L // Q
    xc = xs.reshape(Bb, nc, Q, nh, hd)
    dtc = dt.reshape(Bb, nc, Q, nh)
    Bc = Bm.reshape(Bb, nc, Q, st)
    Cc = Cm.reshape(Bb, nc, Q, st)
    la = la.reshape(Bb, nc, Q, nh)
    la_last = la[:, :, -1:, :]                             # (b,nc,1,nh)

    # intra-chunk: decay L_ij = exp(la_i - la_j) for i >= j.  The j > i
    # entries overflow to inf for large dt, so they are zeroed before the
    # exp as well as after: the same values as the reference's one select,
    # and a finite gradient (the reference's is 0 * inf = NaN in dt and A
    # once a chunk's decay passes e^88; ROADMAP queue C)
    diff = la[:, :, :, None, :] - la[:, :, None, :, :]     # (b,nc,i,j,nh)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xs.device).tril()
    causal = causal[None, None, :, :, None]
    zero = torch.zeros((), dtype=diff.dtype, device=xs.device)
    Lmat = torch.where(causal, torch.exp(torch.where(causal, diff, zero)),
                       zero)
    scores = torch.einsum("bcis,bcjs->bcij", Cc, Bc)       # (b,nc,i,j)
    att = scores[..., None] * Lmat * dtc[:, :, None, :, :]  # (b,nc,i,j,nh)
    y_intra = torch.einsum("bcijn,bcjnh->bcinh", att, xc)

    # chunk summary states
    w = torch.exp(la_last - la) * dtc                      # (b,nc,q,nh)
    S = torch.einsum("bcjn,bcjs,bcjnh->bcnsh", w, Bc, xc)  # (b,nc,nh,st,hd)

    # inter-chunk recurrence
    h = xs.new_zeros((Bb, nh, st, hd))
    y_inter = []
    # the state starts at zero: with autograd on, chunk 0's backward is not
    # the others' (no gradient into the state), so a counter folds the loop
    # only without it
    for c in repeat(nc, fold=not torch.is_grad_enabled()):
        y_inter.append(torch.einsum("bis,bnsh,bin->binh", Cc[:, c], h,
                                    torch.exp(la[:, c])))
        h = h * torch.exp(la_last[:, c, 0])[:, :, None, None] + S[:, c]
    y_inter = torch.stack(unfolded(y_inter, nc), dim=1)

    y = y_intra + y_inter + xc * D[None, None, None, :, None]
    return y.reshape(Bb, L, nh, hd), h


def ssd_scan_plain(xs, dt, A, Bm, Cm, D, chunk: int = 256):
    """The kernel's function in plain PyTorch: the port of the reference's
    ``ssd_scan_ref`` (``models/mamba2.py``), the chunked algorithm with
    chunks of ``Q = min(chunk, L)`` tokens.  xs (B,L,nh,hd), dt (B,L,nh)
    post-softplus, A (nh,) negative, Bm/Cm (B,L,st) (one group, shared by
    all heads), D (nh,) -> (y (B,L,nh,hd), h_final (B,nh,st,hd))."""
    Q = chunk_len(xs.shape[1], chunk)
    return ssd_chunks_plain(xs, dt, chunk_cumsum(dt * A, Q), Bm, Cm, D, Q)


def _check(xs, dt, A, Bm, Cm, D, chunk
           ) -> Tuple[int, int, int, int, int, int]:
    """The checks made before a launch; returns (B, L, nh, hd, st, Q)."""
    f32 = (torch.float32,)
    for name, t, nd in (("xs", xs, 4), ("dt", dt, 3), ("A", A, 1),
                        ("Bm", Bm, 3), ("Cm", Cm, 3), ("D", D, 1)):
        check(name, t, nd, f32)
    B, L, nh, hd = xs.shape
    st = Bm.shape[-1]
    if (tuple(dt.shape) != (B, L, nh) or tuple(A.shape) != (nh,)
            or tuple(D.shape) != (nh,) or tuple(Bm.shape[:2]) != (B, L)
            or Cm.shape != Bm.shape):
        raise ValueError(
            f"shapes do not match: xs {tuple(xs.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, "
            f"Cm {tuple(Cm.shape)}, D {tuple(D.shape)}")
    Q = chunk_len(L, chunk)
    if B < 1 or nh < 1:
        raise ValueError(f"xs {tuple(xs.shape)}: no batch row or no head")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside 1..{MAX_HEAD_DIM}")
    if not 1 <= st <= MAX_STATE:
        raise ValueError(f"state width {st} outside 1..{MAX_STATE}")
    if Q > MAX_CHUNK:
        raise ValueError(f"chunk length {Q} > {MAX_CHUNK}")
    return B, L, nh, hd, st, Q


_FN = None


def _launch(xs, dt, A, Bm, Cm, D, chunk, variant=None):
    """One launch; ``variant`` defaults to :func:`_variant` and is given
    only to time the other kernel set on the same inputs."""
    global _FN
    B, L, nh, hd, st, Q = _check(xs, dt, A, Bm, Cm, D, chunk)
    dev = xs.device
    y = torch.empty_like(xs)
    hout = torch.empty((B, nh, st, hd), dtype=torch.float32, device=dev)
    nc = L // Q
    # scratch: la (B,nh,L), chunk states (B,nh,nc,st,hd), C B^T (B,nc,Q,Q)
    # in rows of Q rounded up to 4 floats (16-byte rows for cp.async)
    la = torch.empty((B, nh, L), dtype=torch.float32, device=dev)
    states = torch.empty((B, nh, nc, st, hd), dtype=torch.float32,
                         device=dev)
    cb = torch.empty((B, nc, Q, -(-Q // 4) * 4), dtype=torch.float32,
                     device=dev)
    if _FN is None:
        from repro_torch.kernels import build
        P, I = ctypes.c_void_p, ctypes.c_int
        _FN = build.function("ssd_scan", "ssd_scan_launch",
                             [P] * 11 + [I] * 7 + [P])
    if variant is None:
        variant = _variant(hd, st, aligned16(xs, Bm, Cm))
    with torch.cuda.device(dev):
        rc = _FN(xs.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), D.data_ptr(), y.data_ptr(), hout.data_ptr(),
                 la.data_ptr(), states.data_ptr(), cb.data_ptr(), B, L, nh,
                 hd, st, Q, VARIANTS[variant], stream_of(xs))
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (CUDA error {rc}, "
                           f"{variant}) for xs {tuple(xs.shape)}, st={st}, "
                           f"Q={Q}")
    ssd_scan.launches += 1
    ssd_scan.last_variant = variant
    return y, hout


def ssd_scan(xs, dt, A, Bm, Cm, D, chunk: int = 256):
    """Same contract as the reference's ``ops.ssd_scan`` (forward only):
    xs (B,L,nh,hd), dt (B,L,nh) post-softplus, A (nh,), Bm/Cm (B,L,st),
    D (nh,), all float32; ``L`` a multiple of ``Q = min(chunk, L)``.
    Returns (y (B,L,nh,hd), h_final (B,nh,st,hd)), float32.  The kernel
    takes hd <= 64, st <= 128 and Q <= 256 and refuses anything else."""
    if on_card(xs, dt, A, Bm, Cm, D):
        refuse_grad("ssd_scan", xs, dt, A, Bm, Cm, D)
        refuse_counting("ssd_scan")
        return _launch(xs, dt, A, Bm, Cm, D, chunk)
    return ssd_scan_plain(xs, dt, A, Bm, Cm, D, chunk)


ssd_scan.launches = 0
ssd_scan.last_variant = None
