"""Port vs reference: the static design-space sweep.

* ``grid_sweep(device="cpu")`` (NumPy float64 broadcast axes) — objectives
  **bit-equal** to ``repro``; Pareto index set, ``topk_indices`` and
  ``design_arrays`` exactly equal.
* the flat-point torch evaluator (the card's path, run here on CPU tensors in
  float64, ``backend="torch"``) — objectives <= 1e-12 relative, area and the
  validity mask exact.
* knobs of the reference surface that are not ported raise
  ``NotImplementedError`` naming the ROADMAP item (``devices=`` beyond one);
  ``chunk_points=`` streams (``tests/test_torch_dse_chunked.py``).
"""
import numpy as np
import pytest
import torch

from repro.configs.vespa_soc import CHSTONE
from repro.core.islands import NOC_LADDER, TILE_LADDER

from _torch_port_helpers import PORT, REF, rel_err

OBJS = ("throughput", "area", "energy_per_unit", "mem_traffic")


def _wls(pkg, names):
    extra = {"fft": (5.90, 2.0)}
    return [pkg.pm.AccelWorkload(n, *{**CHSTONE, **extra}[n]) for n in names]


SMALL = dict(ks=(1, 2), acc_rates=(0.2, 0.6, 1.0), noc_rates=(0.5, 1.0),
             tg_rates=(0.5, 1.0), positions=((1, 1), (3, 3), (0, 2)),
             n_tg=4)

# (workload names, grid_sweep kwargs) — the grids of the reference's
# test_dse_batch / test_dse_islands / test_voltage
GRIDS = {
    "single_full_ladders": (["gsm"], dict(
        ks=(1, 2, 4), acc_rates=TILE_LADDER.levels(),
        noc_rates=NOC_LADDER.levels(), n_tg=2)),
    "joint_collisions": (["dfsin", "gsm"], dict(
        ks=(1, 2), acc_rates=(1.0,), noc_rates=(1.0,),
        positions=((1, 1), (3, 3), (0, 2)), n_tg=0)),
    "joint_mem_traffic": (["dfadd", "dfmul"], dict(
        ks=(1, 2), acc_rates=(0.2, 1.0), noc_rates=(0.5, 1.0),
        tg_rates=(0.5, 1.0), positions=((1, 1), (3, 3)), n_tg=6)),
    "small_shared": (["dfsin", "gsm"], SMALL),
    "small_independent": (["dfsin", "gsm"],
                          dict(SMALL, island_rates="independent")),
    "independent_hetero_ladders": (["dfsin", "gsm"], dict(
        SMALL, island_rates="independent",
        acc_rates={"dfsin": (0.4, 1.0), "gsm": (0.2, 0.6, 0.8, 1.0)})),
    "three_accels": (["dfadd", "dfmul", "dfsin"], dict(
        ks=(1, 4), acc_rates=(0.2, 1.0), noc_rates=(0.5, 1.0),
        positions=((1, 1), (3, 3), (0, 2), (2, 0)), n_tg=3)),
    "tech_axis": (["dfmul", "fft"], dict(
        ks=(1, 2), acc_rates=(0.4, 0.7, 1.0), noc_rates=(0.5, 1.0), n_tg=2,
        positions=((1, 1), (3, 3)), tech_node=(45, 16),
        tech_variant="cons")),
    "tech_axis_independent": (["dfmul", "fft"], dict(
        ks=(2, 4), acc_rates=(0.4, 0.7, 1.0, 1.3), noc_rates=(0.5, 1.0),
        n_tg=2, positions=((1, 1), (3, 3), (0, 2)),
        island_rates="independent", tech_node=16,
        tech_variant=("itrs", "cons"))),
}


def _pair(key, **port_kw):
    names, kw = GRIDS[key]
    ref = REF.dse.grid_sweep(REF.pm.SoCPerfModel(), _wls(REF, names), **kw)
    got = PORT.dse.grid_sweep(PORT.pm.SoCPerfModel(), _wls(PORT, names),
                              device="cpu", **kw, **port_kw)
    return ref, got


@pytest.mark.parametrize("key", list(GRIDS))
def test_grid_sweep_cpu_is_bit_equal(key):
    ref, got = _pair(key)
    assert got.backend == "numpy"
    assert got.axes == ref.axes and got.shape == ref.shape
    assert got.n_tg == ref.n_tg and len(got) == len(ref)
    for obj in OBJS:
        assert np.array_equal(getattr(got, obj), getattr(ref, obj)), obj
    assert np.array_equal(got.valid, ref.valid)
    assert got.n_valid == ref.n_valid


@pytest.mark.parametrize("key", list(GRIDS))
def test_pareto_topk_and_decode_equal(key):
    ref, got = _pair(key)
    assert np.array_equal(got.pareto_indices(), ref.pareto_indices())
    for obj, k in (("throughput", 20), ("energy_per_unit", 7), ("area", 5),
                   ("mem_traffic", 9)):
        assert np.array_equal(got.topk_indices(k, obj),
                              ref.topk_indices(k, obj)), obj
    idx = ref.pareto_indices()[:16]
    da, db = ref.design_arrays(idx), got.design_arrays(idx)
    assert da.keys() == db.keys()
    for name in da:
        assert np.array_equal(da[name], db[name]), name
    i = int(ref.topk_indices(1)[0])
    pa, pb = ref.design_point(i), got.design_point(i)
    assert pa.key() == pb.key()
    assert (pa.throughput, pa.area, pa.energy_per_unit) == \
        (pb.throughput, pb.area, pb.energy_per_unit)
    assert ref.island_rates(i) == got.island_rates(i)
    assert ref.independent_islands == got.independent_islands


@pytest.mark.parametrize("key", list(GRIDS))
def test_flat_point_torch_evaluator(key):
    """The card's evaluator on CPU tensors, float64: <= 1e-12 relative."""
    ref, got = _pair(key, backend="torch")
    assert got.backend == "torch"
    for obj in ("throughput", "energy_per_unit", "mem_traffic"):
        assert rel_err(getattr(got, obj), getattr(ref, obj)) <= 1e-12, obj
    assert np.array_equal(got.area, ref.area)
    assert np.array_equal(got.valid, ref.valid)
    assert np.array_equal(got.pareto_indices(), ref.pareto_indices())


def test_flat_point_torch_evaluator_float32():
    """Optional float32 evaluation: float32 rounding only (<= 5e-6 rel)."""
    ref, got = _pair("small_independent", backend="torch",
                     dtype=torch.float32)
    for obj in ("throughput", "energy_per_unit", "mem_traffic"):
        assert rel_err(getattr(got, obj), getattr(ref, obj)) <= 5e-6, obj
    assert np.array_equal(got.area, ref.area)       # area stays float64


def test_flat_points_subrange_matches_dense():
    """Evaluating a sub-range of flat indices gives the dense rows (the
    device decode is the C-order unravel_index)."""
    names, kw = GRIDS["tech_axis"]
    model, wls = PORT.pm.SoCPerfModel(), tuple(_wls(PORT, names))
    dense = PORT.dse.grid_sweep(model, wls, device="cpu", **kw)
    lay, axes, vals = PORT.dse._prepare_axes(
        model, wls, kw["ks"], kw["acc_rates"], kw["noc_rates"], (1.0,),
        kw["positions"], "shared", tech_node=kw["tech_node"],
        tech_variant=kw["tech_variant"])
    lo, hi = 17, 131
    part = PORT.dse._eval_flat_points(model, wls, kw["n_tg"], lay, vals,
                                      dense.shape, lo, hi, device="cpu")
    for obj in ("throughput", "energy_per_unit", "mem_traffic"):
        assert rel_err(part[obj], getattr(dense, obj)[lo:hi]) <= 1e-12
    assert np.array_equal(part["area"], dense.area[lo:hi])
    assert np.array_equal(part["valid"], dense.valid[lo:hi])


def test_pareto_front_functions_equal():
    rng = np.random.default_rng(2)
    thr = rng.integers(0, 6, 300).astype(float)
    area = rng.integers(0, 5, 300).astype(float)
    en = rng.integers(0, 7, 300).astype(float)
    assert np.array_equal(REF.dse.pareto_front_indices(thr, area, en),
                          PORT.dse.pareto_front_indices(thr, area, en))
    pts = [PORT.dse.DesignPoint({}, {}, {}, t, a, e)
           for t, a, e in zip(thr[:80], area[:80], en[:80])]
    fast = PORT.dse.pareto_front(pts)
    brute = PORT.dse.pareto_front_bruteforce(pts)
    assert sorted(map(id, fast)) == sorted(map(id, brute))
    assert PORT.dse.pareto_front_indices([], [], []).shape == (0,)


def test_rank_scores_equal():
    rng = np.random.default_rng(4)
    p99 = rng.uniform(1e-3, 0.1, 40)
    ept = rng.uniform(1e-3, 1.0, 40)
    p99[[3, 9]] = np.nan
    ept[[9, 17]] = np.nan
    for sla in (None, 0.03):
        assert np.array_equal(REF.dse._rank_scores(p99, ept, sla),
                              PORT.dse._rank_scores(p99, ept, sla))


# ------------------------------------------------------- refusals / device
def test_chunk_points_refused_when_grid_exceeds_it():
    """(The name is historical: the chunked sweep was refused until it was
    ported.)  A grid larger than ``chunk_points`` now streams and returns a
    ``ChunkedSweepResult`` equal to the reference's; a chunk size the grid
    fits in is the dense sweep."""
    names, kw = GRIDS["small_shared"]
    model, wls = PORT.pm.SoCPerfModel(), _wls(PORT, names)
    res = PORT.dse.grid_sweep(model, wls, device="cpu", chunk_points=50, **kw)
    ref = REF.dse.grid_sweep(REF.pm.SoCPerfModel(), _wls(REF, names),
                             chunk_points=50, **kw)
    assert isinstance(res, PORT.dse.ChunkedSweepResult)
    assert np.array_equal(res.pareto_indices(), ref.pareto_indices())
    assert np.array_equal(res.cand_indices, ref.cand_indices)
    for obj in OBJS:
        assert np.array_equal(res.topk[obj], ref.topk[obj]), obj
        assert np.array_equal(res.cand_values[obj], ref.cand_values[obj])
    assert (res.n_valid, res.n_chunks, res.peak_chunk_bytes) == \
        (ref.n_valid, ref.n_chunks, ref.peak_chunk_bytes)
    res = PORT.dse.grid_sweep(model, wls, device="cpu",
                              chunk_points=10 ** 6, **kw)
    assert isinstance(res, PORT.dse.SweepResult)


def test_devices_beyond_one_refused(monkeypatch):
    """``devices=`` is ported (queue A item 12a): a count below one is
    refused as the reference refuses it, and two shards give the one-shard
    sweep (``tests/test_torch_shard.py`` holds every count)."""
    names, kw = GRIDS["small_shared"]
    model, wls = PORT.pm.SoCPerfModel(), _wls(PORT, names)
    with pytest.raises(AssertionError):
        PORT.dse.grid_sweep(model, wls, device="cpu", devices=0, **kw)
    monkeypatch.setenv("REPRO_TORCH_FORCE_DEVICE_COUNT", "2")
    one = PORT.dse.grid_sweep(model, wls, device="cpu", devices=1, **kw)
    two = PORT.dse.grid_sweep(model, wls, device="cpu", devices=2, **kw)
    for f in ("throughput", "area", "energy_per_unit", "mem_traffic",
              "valid"):
        assert np.array_equal(getattr(two, f), getattr(one, f)), f


def test_default_device_is_the_card():
    """No silent CPU run: without a CUDA device the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    names, kw = GRIDS["small_shared"]
    with pytest.raises(RuntimeError, match="CUDA"):
        PORT.dse.grid_sweep(PORT.pm.SoCPerfModel(), _wls(PORT, names), **kw)
