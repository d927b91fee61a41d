"""The port's SSD scan against the reference's, on the CPU.

``ssd_scan_plain`` (what the ``ssd_scan`` wrapper runs on CPU tensors) is
held against the reference's ``ssd_scan_pallas(..., interpret=True)`` and
its ``kernels/ref.py:ssd_scan_ref`` oracle on the same inputs made with
NumPy from a seed, and against the token-by-token state recurrence, at the
reference's tolerance (``tests/test_kernels.py``: atol = rtol = 1e-4 on y
and h).  Also: the wrapper's signature and refusals, and the check that
``chip_smoke.py`` applies on the card (it must pass a right answer computed
another way and reject planted faults).  The CUDA kernel itself is held
against the plain version by the ``gpu``-marked tests (skipped without a
card), whose cases run in ``chip_smoke.py`` (``card_case``: the card's
machine has no jax), and there by its own phases.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as REF
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ssd_scan as SS
from repro_torch.models import mamba2 as PM

from _torch_port_helpers import chip_smoke

TOL = 1e-4                      # tests/test_kernels.py:68-69

# B, L, nh, hd, st, chunk, dt scale
CASES = [
    (2, 128, 3, 32, 16, 32, 1.0),       # the four shapes of
    (1, 64, 1, 8, 8, 16, 1.0),          # tests/test_kernels.py:52-57
    (1, 256, 2, 64, 128, 64, 1.0),
    (3, 96, 4, 16, 32, 32, 1.0),
    (1, 100, 2, 16, 8, 256, 1.0),       # a ragged single chunk: Q = 100
    (2, 2, 3, 8, 8, 256, 1.0),          # L = 2: Q = 2
    (1, 1, 2, 8, 8, 256, 1.0),          # L = 1
    (2, 64, 2, 8, 8, 16, 50.0),         # large dt: exp overflows above the
]                                       # diagonal, the mask is a select


def inputs(B, L, nh, hd, st, dt_scale=1.0, seed=0, D_zero=False):
    """NumPy float32 inputs drawn as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, L, nh, hd))
    dt = np.logaddexp(rng.standard_normal((B, L, nh)), 0.0) * dt_scale
    A = -np.exp(0.2 * rng.standard_normal(nh))
    Bm = rng.standard_normal((B, L, st))
    Cm = rng.standard_normal((B, L, st))
    D = np.zeros(nh) if D_zero else np.ones(nh)
    return [np.asarray(a, np.float32) for a in (xs, dt, A, Bm, Cm, D)]


def close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,L,nh,hd,st,chunk,dt_scale", CASES)
def test_plain_and_wrapper_match_pallas_and_oracle(B, L, nh, hd, st, chunk,
                                                   dt_scale):
    a = inputs(B, L, nh, hd, st, dt_scale)
    y, h = SS.ssd_scan_plain(*map(torch.from_numpy, a), chunk)
    assert y.shape == (B, L, nh, hd) and h.shape == (B, nh, st, hd)
    assert y.dtype == h.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    before = SS.ssd_scan.launches
    wy, wh = port_ops.ssd_scan(*map(torch.from_numpy, a), chunk)
    assert SS.ssd_scan.launches == before        # CPU tensors: no launch
    assert torch.equal(wy, y) and torch.equal(wh, h)
    ja = list(map(jnp.asarray, a))
    py, ph = ssd_scan_pallas(*ja, chunk=chunk, interpret=True)
    oy, oh = REF.ssd_scan_ref(*ja, chunk=chunk)
    for port, ref in ((y, py), (h, ph), (y, oy), (h, oh)):
        close(port, ref)


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_plain_matches_the_sequential_recurrence(chunk):
    """tests/test_kernels.py::test_ssd_matches_sequential_recurrence on the
    port: any chunk gives the token-by-token state recurrence."""
    B, L, nh, hd, st = 1, 48, 2, 8, 4
    xs, dt, A, Bm, Cm, D = inputs(B, L, nh, hd, st, seed=1, D_zero=True)
    x64 = [a.astype(np.float64) for a in (xs, dt, A, Bm, Cm)]
    h = np.zeros((B, nh, st, hd))
    ys = []
    for t in range(L):
        a = np.exp(x64[1][:, t] * x64[2])                        # (B,nh)
        upd = np.einsum("bn,bs,bnh->bnsh", x64[1][:, t], x64[3][:, t],
                        x64[0][:, t])
        h = h * a[:, :, None, None] + upd
        ys.append(np.einsum("bs,bnsh->bnh", x64[4][:, t], h))
    y_seq = np.stack(ys, axis=1)
    y, hf = SS.ssd_scan_plain(*map(torch.from_numpy,
                                   (xs, dt, A, Bm, Cm, D)), chunk)
    close(y, y_seq)
    close(hf, h)


def test_model_scan_is_the_plain_version():
    """``models/mamba2.ssd_scan_ref`` (the ``"torch"`` backend) is the
    kernel's plain version."""
    a = list(map(torch.from_numpy, inputs(1, 64, 2, 8, 8, seed=2)))
    y, h = PM.ssd_scan_ref(*a, chunk=16)
    py, ph = SS.ssd_scan_plain(*a, chunk=16)
    assert torch.equal(y, py) and torch.equal(h, ph)


def test_ops_signature_matches_the_reference():
    ref = inspect.signature(ref_ops.ssd_scan)
    port = inspect.signature(port_ops.ssd_scan)
    assert list(port.parameters) == list(ref.parameters)
    for p in ref.parameters.values():
        assert port.parameters[p.name].default == p.default


def test_refusals_fire_before_any_launch():
    """The checks a launch makes first raise before the CUDA build or the
    card is touched (here on CPU tensors, through the launch path)."""
    a = list(map(torch.from_numpy, inputs(1, 64, 2, 8, 8)))
    xs, dt, A, Bm, Cm, D = a
    before, fn = SS.ssd_scan.launches, SS._FN
    with pytest.raises(TypeError, match="dtype"):
        SS._launch(xs.double(), dt, A, Bm, Cm, D, 16)
    with pytest.raises(TypeError, match="dtype"):
        SS._launch(xs, dt, A, Bm.to(torch.bfloat16), Cm, D, 16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        SS._launch(xs, dt, A, Bm, Cm, D, 48)          # 64 % 48 != 0
    with pytest.raises(ValueError, match="do not match"):
        SS._launch(xs, dt[:, :32], A, Bm, Cm, D, 16)
    with pytest.raises(ValueError, match="do not match"):
        SS._launch(xs, dt, A, Bm, Cm[..., :4].contiguous(), D, 16)
    with pytest.raises(ValueError, match="4-d"):
        SS._launch(xs[0], dt, A, Bm, Cm, D, 16)
    with pytest.raises(ValueError, match="contiguous"):
        SS._launch(torch.zeros(1, 64, 2, 16)[..., ::2], dt, A, Bm, Cm, D, 16)
    with pytest.raises(ValueError, match="state width"):
        big = torch.zeros(1, 64, 200)
        SS._launch(xs, dt, A, big, big, D, 16)
    with pytest.raises(ValueError, match="head dim"):
        SS._launch(torch.zeros(1, 64, 2, 80), dt, A, Bm, Cm, D, 16)
    with pytest.raises(ValueError, match="chunk length 512"):
        L = 1024
        SS._launch(torch.zeros(1, L, 2, 8), torch.zeros(1, L, 2), A,
                   torch.zeros(1, L, 8), torch.zeros(1, L, 8), D, 512)
    with pytest.raises(ValueError, match=">= 1"):
        SS._launch(xs, dt, A, Bm, Cm, D, 0)
    with pytest.raises(ValueError, match="no batch row"):
        SS._launch(xs[:0], dt[:0], A, Bm[:0], Cm[:0], D, 16)
    with pytest.raises(ValueError, match="device"):
        SS.ssd_scan(*(t.to("meta") for t in a), 16)
    # the plain version refuses what the reference asserts
    with pytest.raises(ValueError, match="multiple of the chunk"):
        SS.ssd_scan_plain(xs, dt, A, Bm, Cm, D, 48)
    assert SS.ssd_scan.launches == before
    assert SS._FN is fn                    # nothing was built or loaded


# ------------------------------------------- the check chip_smoke.py applies
@pytest.fixture(scope="module")
def cs_cpu():
    cs = chip_smoke()
    cs.DEV = "cpu"                     # draw the inputs on the CPU here
    return cs


def test_ssd_check_passes_a_right_answer_and_rejects_planted_faults(cs_cpu):
    """``chip_smoke.py``'s ssd check at 8 chunks of Mamba-2-like inputs:
    the sequential recurrence in float64 (a right answer computed another
    way) passes; each planted fault is rejected, per element and per
    (batch, head)."""
    cs = cs_cpu
    g = torch.Generator().manual_seed(7)
    L, nh, hd, st, chunk = 512, 4, 16, 32, 64
    args = cs.ssd_case(g, 1, L, nh, hd, st, "mamba")
    ref = SS.ssd_scan_plain(*args, chunk)
    xs, dt, A, Bm, Cm, D = (t.double() for t in args)
    h = torch.zeros(1, nh, st, hd, dtype=torch.float64)
    ys = []
    for t in range(L):
        h = (h * torch.exp(dt[:, t] * A)[:, :, None, None]
             + torch.einsum("bn,bs,bnh->bnsh", dt[:, t], Bm[:, t], xs[:, t]))
        ys.append(torch.einsum("bs,bnsh->bnh", Cm[:, t], h)
                  + xs[:, t] * D[None, :, None])
    seq = (torch.stack(ys, 1).float(), h.float())
    assert cs.ssd_check(*seq, *ref)["ok"]
    faults = cs.ssd_planted_faults(args, chunk, ref)
    assert set(faults) == {"carry_dropped", "no_D", "decay_shifted",
                           "superdiag"}
    for fault, (fy, fh) in faults.items():
        res = cs.ssd_check(fy, fh, *ref)
        assert not res["ok"], fault
        assert res["max_row_rel_err"] > cs.SSD_TOL, fault


def test_ssd_bound_counts_the_live_pairs(cs_cpu):
    """At the 16,384-token prefill of mamba2-370m: ~2.6e10 operations
    (C B^T once per chunk, live pairs only) over 67 TFLOP/s, ~0.29 GB."""
    ops, byts, (ms, by) = cs_cpu.ssd_bound(1, 16384, 32, 64, 128, 256)
    pairs = 256 * 257 / 2
    assert ops == (2 * 64 * pairs * 128 + 32 * 64 * pairs * (3 + 2 * 64)
                   + 4.0 * 16384 * 32 * 128 * 64)
    assert 2.5e10 < ops < 2.8e10 and 0.28e9 < byts < 0.3e9
    assert by == "operations" and abs(ms - ops / 67e12 * 1e3) < 1e-12


# ------------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode (chip_smoke.py runs these comparisons on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,nh,hd,st,chunk,dt_scale", CASES)
def test_cuda_ssd_scan_matches_plain(B, L, nh, hd, st, chunk, dt_scale,
                                     cuda_device):
    """The kernel against the plain version (atol = rtol = 1e-4) on
    ``inputs``; the case runs in ``chip_smoke.py`` (``card_ssd_scan``),
    which the card's machine can run."""
    chip_smoke().card_case("test_cuda_ssd_scan_matches_plain", B, L, nh,
                            hd, st, chunk, dt_scale)


# ------------------------------------------ the tf32x3 kernels (CPU parts)
def test_ssd_dispatch_rule():
    """``ssd_scan._variant``: the tensor-core set for mamba2-370m's widths
    (hd 64, st 128) and every hd / st multiple of 4 with aligned operands;
    the float32 CUDA-core set for other widths or a misaligned view."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-370m")
    assert SS._variant(cfg.ssm_headdim, cfg.ssm_state, True) == "tf32x3"
    assert SS._variant(cfg.ssm_headdim, cfg.ssm_state, False) == "cuda_cores"
    for hd, st in ((32, 16), (8, 8), (64, 4), (4, 128), (20, 24)):
        assert SS._variant(hd, st, True) == "tf32x3"
    for hd, st in ((64, 126), (30, 16), (1, 1)):
        assert SS._variant(hd, st, True) == "cuda_cores"
    buf = torch.zeros(1 + 64 * 8)
    view = buf[1:].view(1, 64, 8)
    assert view.is_contiguous() and not SS.aligned16(view)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds; returned as float32."""
    b = x.contiguous().view(torch.int32)
    sign = b & torch.tensor(-2 ** 31, dtype=torch.int32)
    mag = (b & 0x7FFFFFFF) + 0x1000
    return (sign | (mag & ~0x1FFF)).view(torch.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product(eq, a, b, mode):
    """``einsum(eq, a, b)`` of float32 operands as the card would form it:
    ``f32`` plain; ``tf32`` one TF32 pass; ``tf32x3`` a_lo b_hi + a_hi b_lo
    + a_hi b_hi.  Products and sums in float64, so only the operand split
    differs between the modes."""
    if mode == "f32":
        return torch.einsum(eq, a, b)
    d = torch.float64
    if mode == "tf32":
        return torch.einsum(eq, tf32_rna(a).to(d), tf32_rna(b).to(d)).float()
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return (torch.einsum(eq, al.to(d), bh.to(d))
            + torch.einsum(eq, ah.to(d), bl.to(d))
            + torch.einsum(eq, ah.to(d), bh.to(d))).float()


def ssd_chunks_products(xs, dt, la, Bm, Cm, D, Q, mode):
    """``ssd_chunks_plain`` with its four products (C B^T, att @ x, the
    chunk states (B w)^T x, C @ h_in) formed as ``product`` forms them."""
    Bb, L, nh, hd = xs.shape
    st = Bm.shape[-1]
    nc = L // Q
    xc = xs.reshape(Bb, nc, Q, nh, hd)
    dtc = dt.reshape(Bb, nc, Q, nh)
    Bc, Cc = Bm.reshape(Bb, nc, Q, st), Cm.reshape(Bb, nc, Q, st)
    la = la.reshape(Bb, nc, Q, nh)
    la_last = la[:, :, -1:, :]
    diff = la[:, :, :, None, :] - la[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    Lmat = torch.where(causal[None, None, :, :, None], torch.exp(diff),
                       torch.zeros(()))
    scores = product("bcis,bcjs->bcij", Cc, Bc, mode)
    att = scores[..., None] * Lmat * dtc[:, :, None, :, :]
    y_intra = product("bcijn,bcjnh->bcinh", att, xc, mode)
    w = torch.exp(la_last - la) * dtc
    Bw = w[..., None] * Bc[:, :, :, None, :]                 # (b,c,j,n,s)
    S = product("bcjns,bcjnh->bcnsh", Bw, xc, mode)
    h = xs.new_zeros((Bb, nh, st, hd))
    y_inter = torch.empty_like(xc)
    for c in range(nc):
        ch = product("bis,bnsh->binh", Cc[:, c], h, mode)
        y_inter[:, c] = ch * torch.exp(la[:, c])[..., None]
        h = h * torch.exp(la_last[:, c, 0])[:, :, None, None] + S[:, c]
    y = y_intra + y_inter + xc * D[None, None, None, :, None]
    return y.reshape(Bb, L, nh, hd), h


def test_tf32_rounding_is_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0e-3, -7.5], dtype=torch.float32)
    r = tf32_rna(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2 ** -10        # tie: away from 0
    assert r[2] == 1.0 + 2 ** -9 and r[3] == -(1.0 + 2 ** -10)
    assert r[5] == -7.5
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    hi, lo = split_tf32(x)
    assert torch.equal(hi + lo, x)                 # exact on these values


def test_3xtf32_holds_the_ssd_limit_and_one_pass_does_not(cs_cpu):
    """On Mamba-2's ranges (``ssd_case`` "mamba", two chunks at the path's
    widths) the scan with its four products in 3xTF32 (the split of
    ``ssd_scan.cu``'s tf32x3 kernels) stays within ``SSD_TOL`` of the
    float32 plain version, per element and per (batch, head); one TF32 pass
    does not."""
    cs = cs_cpu
    g = torch.Generator().manual_seed(3)
    L, nh, hd, st, chunk = 512, 4, 64, 128, 256
    args = cs.ssd_case(g, 1, L, nh, hd, st, "mamba")
    xs, dt, A, Bm, Cm, D = args
    ref = SS.ssd_scan_plain(*args, chunk)
    la = SS.chunk_cumsum(dt * A, chunk)
    f32 = ssd_chunks_products(xs, dt, la, Bm, Cm, D, chunk, "f32")
    assert cs.ssd_check(*f32, *ref)["ok"]
    x3 = cs.ssd_check(*ssd_chunks_products(xs, dt, la, Bm, Cm, D, chunk,
                                           "tf32x3"), *ref)
    x1 = cs.ssd_check(*ssd_chunks_products(xs, dt, la, Bm, Cm, D, chunk,
                                           "tf32"), *ref)
    assert x3["ok"], x3
    assert not x1["ok"], x1
    assert x1["max_abs_err"] > 10 * x3["max_abs_err"]


def test_ssd_bound_tc_at_the_serving_shape(cs_cpu):
    """With the products on tensor cores in 3xTF32 the 16,384-token call's
    bound is ~0.16 ms, by operations: three times the 2.63e10 product
    operations at 494 TFLOP/s plus the pairs' decay at 67 TFLOP/s."""
    ms, by = cs_cpu.ssd_bound_tc(1, 16384, 32, 64, 128, 256)
    pairs = 256 * 257 / 2
    prod = (2 * 64 * pairs * 128 + 32 * 64 * pairs * 2 * 64
            + 4.0 * 16384 * 32 * 128 * 64)
    assert abs(ms - (3 * prod / 494e12 + 3 * 32 * 64 * pairs / 67e12) * 1e3) \
        < 1e-12
    assert by == "operations" and 0.15 < ms < 0.17
    f32_ms = cs_cpu.ssd_bound(1, 16384, 32, 64, 128, 256)[2][0]
    assert f32_ms > 2 * ms


# B, L, nh, hd, st, chunk, dt draw: Q = 1, 8, 100, 256; st 16 / 128; hd
# 32 / 64; large dt (chip_smoke.py EDGE_SSD holds the same)
EDGE_SSD = [
    (2, 256, 3, 32, 16, 1, "normal"),
    (1, 64, 4, 32, 16, 8, "normal"),
    (1, 200, 2, 64, 128, 100, "large_dt"),
    (1, 1024, 8, 32, 128, 256, "mamba"),
    (1, 512, 4, 64, 16, 256, "mamba"),
    (2, 768, 4, 64, 128, 256, "large_dt"),
]


def test_edge_ssd_cases_match_chip_smoke(cs_cpu):
    assert [tuple(c) for c in EDGE_SSD] == list(cs_cpu.EDGE_SSD)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,nh,hd,st,chunk,kind", EDGE_SSD)
def test_cuda_ssd_scan_tf32x3_edges(B, L, nh, hd, st, chunk, kind,
                                    cuda_device):
    """The tf32x3 kernels against the plain version at their edges, with
    ``chip_smoke.py``'s check (SSD_TOL per element and per (batch,
    head)); runs as its ``card_ssd_scan_tf32x3_edges``."""
    chip_smoke().card_case("test_cuda_ssd_scan_tf32x3_edges", B, L, nh, hd,
                            st, chunk, kind)


@pytest.mark.gpu
def test_cuda_misaligned_ssd_takes_the_cuda_core_kernels(cuda_device):
    """An xs view 4 bytes into its buffer takes the cuda_cores kernels,
    which agree with the plain version (``card_misaligned_ssd``)."""
    chip_smoke().card_case(
        "test_cuda_misaligned_ssd_takes_the_cuda_core_kernels")
