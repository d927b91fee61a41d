"""Port vs reference: the chunked streaming sweep, the Pareto prefilter and
the scalar sweep / summaries of ``core/dse.py``.

* ``grid_sweep(..., chunk_points=N)`` returns a ``ChunkedSweepResult``.
  With ``backend="numpy"`` (the host block loop) its Pareto front, top-k,
  tracked indices, tracked values, ``n_valid``, ``n_chunks`` and
  ``peak_chunk_bytes`` are **bit-equal** to the reference's chunked sweep;
  with ``backend="torch"`` (the flat evaluator, here on CPU tensors in
  float64; mask, prefilter and top-k on the device) the index sets are
  equal and the values within 1e-12 relative, the rule of the dense sweep's
  torch evaluator.  Both equal the reference's one-shot sweep.
* ``_front_prefilter`` keeps a superset of the front (over NumPy arrays and
  torch tensors alike), and the exact scan over its candidates is the front
  of all points (``pareto_front_bruteforce``), on grids with exact
  duplicates and ties; ``SweepResult.pareto_indices`` goes through it.
* ``sweep_soc`` equals the reference's point for point; ``summarize`` /
  ``summarize_result`` give the same strings.
"""
import numpy as np
import pytest
import torch

from repro.configs.vespa_soc import CHSTONE

from _torch_port_helpers import PORT, REF, chip_smoke, rel_err

OBJS = ("throughput", "area", "energy_per_unit", "mem_traffic")
SMALL = dict(ks=(1, 2), acc_rates=(0.2, 0.6, 1.0), noc_rates=(0.5, 1.0),
             tg_rates=(0.5, 1.0), positions=((1, 1), (3, 3), (0, 2)),
             n_tg=4)


def _wls(pkg, names=("dfsin", "gsm")):
    return [pkg.pm.AccelWorkload(n, *CHSTONE[n]) for n in names]


def _sweeps(mode, chunk, backend, topk_track=16, **extra):
    kw = dict(SMALL, island_rates=mode, **extra)
    ref_ch = REF.dse.grid_sweep(REF.pm.SoCPerfModel(), _wls(REF), **kw,
                                chunk_points=chunk, topk_track=topk_track)
    ref_one = REF.dse.grid_sweep(REF.pm.SoCPerfModel(), _wls(REF), **kw)
    got = PORT.dse.grid_sweep(PORT.pm.SoCPerfModel(), _wls(PORT), **kw,
                              chunk_points=chunk, topk_track=topk_track,
                              device="cpu", backend=backend)
    return ref_ch, ref_one, got


# ------------------------------------------------- chunked == reference
@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("mode", ["shared", "independent"])
@pytest.mark.parametrize("chunk", [17, 101, 430])
def test_chunked_equals_reference(chunk, mode, backend):
    ref, one, got = _sweeps(mode, chunk, backend)
    assert isinstance(got, PORT.dse.ChunkedSweepResult)
    assert got.backend == backend
    assert (len(got), got.n_valid, got.n_chunks, got.topk_track,
            got.chunk_points) == (len(ref), ref.n_valid, ref.n_chunks,
                                  ref.topk_track, ref.chunk_points)
    assert got.axes == ref.axes and got.shape == ref.shape
    assert got.peak_chunk_bytes == ref.peak_chunk_bytes
    assert np.array_equal(got.pareto_indices(), ref.pareto_indices())
    assert np.array_equal(got.pareto_indices(), one.pareto_indices())
    assert np.array_equal(got.cand_indices, ref.cand_indices)
    assert got.cand_indices.dtype == np.int64
    for obj in OBJS:
        assert np.array_equal(got.topk[obj], ref.topk[obj]), obj
        assert np.array_equal(got.topk_indices(10, obj),
                              one.topk_indices(10, obj)), obj
        if backend == "numpy":
            assert np.array_equal(got.cand_values[obj],
                                  ref.cand_values[obj]), obj
        else:
            assert rel_err(got.cand_values[obj],
                           ref.cand_values[obj]) <= 1e-12, obj
        pf = got.pareto_indices()
        assert rel_err(got.objective_values(obj, pf),
                       one.objective_values(obj, pf)) <= (
            0.0 if backend == "numpy" else 1e-12)
    i = int(got.topk_indices(1)[0])
    dp, dr = got.design_point(i), one.design_point(i)
    assert dp.key() == dr.key()
    assert got.island_rates(i) == one.island_rates(i)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_chunked_tech_axis_and_three_accels(backend):
    """A trailing tech axis and a third accelerator stream like any other
    axis (blocks of whole trailing panels)."""
    kw = dict(ks=(1, 4), acc_rates=(0.4, 1.0), noc_rates=(0.5, 1.0),
              positions=((1, 1), (3, 3), (0, 2), (2, 0)), n_tg=3,
              tech_node=(45, 16), tech_variant="cons")
    names = ("dfadd", "dfmul", "dfsin")
    ref = REF.dse.grid_sweep(REF.pm.SoCPerfModel(), _wls(REF, names), **kw,
                             chunk_points=333, topk_track=12)
    got = PORT.dse.grid_sweep(PORT.pm.SoCPerfModel(), _wls(PORT, names),
                              **kw, chunk_points=333, topk_track=12,
                              device="cpu", backend=backend)
    assert np.array_equal(got.pareto_indices(), ref.pareto_indices())
    for obj in OBJS:
        assert np.array_equal(got.topk[obj], ref.topk[obj]), obj
    assert got.n_valid == ref.n_valid and got.n_chunks == ref.n_chunks


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_chunked_lookup_guardrails(backend):
    _, one, ch = _sweeps("shared", 50, backend, topk_track=8)
    tracked = int(ch.topk_indices(1)[0])
    ch.objective_values("throughput", [tracked])
    untracked = int(np.setdiff1d(np.arange(len(ch)), ch.cand_indices)[0])
    with pytest.raises(KeyError):
        ch.objective_values("throughput", [untracked])
    with pytest.raises(ValueError):
        ch.topk_indices(9)                              # > topk_track
    with pytest.raises(KeyError):
        ch.topk_indices(3, "throughput", maximize=False)
    with pytest.raises(KeyError):
        ch.topk_indices(3, "valid")
    dp, ref = ch.design_point(untracked), one.design_point(untracked)
    assert (dp.replication, dp.placement, dp.rates) == \
        (ref.replication, ref.placement, ref.rates)
    assert np.isnan(dp.throughput) and np.isnan(dp.area) \
        and np.isnan(dp.energy_per_unit)
    assert ch.island_rates(untracked) == one.island_rates(untracked)
    assert ch.points_per_second > 0


def test_chunk_larger_than_grid_is_the_dense_sweep():
    res = PORT.dse.grid_sweep(PORT.pm.SoCPerfModel(), _wls(PORT), **SMALL,
                              chunk_points=10 ** 6, device="cpu")
    assert isinstance(res, PORT.dse.SweepResult)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_closed_loop_score_on_chunked_independent(backend):
    """The pipeline on a chunked per-island sweep: streaming sweep ->
    Pareto survivors -> one batched replay, against the reference's."""
    kw = dict(ks=(1, 2), acc_rates=(0.2, 0.6, 1.0), noc_rates=(0.5, 1.0),
              tg_rates=(1.0,), positions=((1, 1), (3, 3), (0, 2)), n_tg=4,
              island_rates="independent", chunk_points=100)
    rm, pm = REF.pm.SoCPerfModel(), PORT.pm.SoCPerfModel()
    ref = REF.dse.grid_sweep(rm, _wls(REF), **kw)
    got = PORT.dse.grid_sweep(pm, _wls(PORT), **kw, device="cpu",
                              backend=backend)
    sc_r = REF.dse.closed_loop_score(
        ref, lambda seed: REF.sim.diurnal_trace(5000.0, 400, 2, dt=1e-3,
                                                seed=seed),
        model=rm, top=4)
    sc_p = PORT.dse.closed_loop_score(
        got, lambda seed: PORT.sim.diurnal_trace(5000.0, 400, 2, dt=1e-3,
                                                 seed=seed),
        model=pm, top=4, device="cpu")
    assert np.array_equal(sc_p.indices, sc_r.indices)
    assert np.array_equal(sc_p.ranked_indices(), sc_r.ranked_indices())
    for f in ("p99_latency_s", "energy_per_request_j", "throughput_rps"):
        assert rel_err(getattr(sc_p, f), getattr(sc_r, f)) <= 1e-12, f


# ------------------------------------------------------------- prefilter
def _grid_objectives(seed, n=400):
    """Objectives on a coarse integer grid: exact duplicates, ties on every
    objective, a handful of area classes."""
    rng = np.random.default_rng(seed)
    thr = rng.integers(0, 8, n).astype(float)
    area = rng.integers(0, 4, n).astype(float) * 0.25
    en = rng.integers(0, 9, n).astype(float)
    dup = rng.integers(0, n, n // 5)
    thr[:n // 5], area[:n // 5], en[:n // 5] = thr[dup], area[dup], en[dup]
    return thr, area, en


@pytest.mark.parametrize("on", ["numpy", "torch"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_prefilter_superset_and_exact_front(seed, on):
    thr, area, en = _grid_objectives(seed)
    front = PORT.dse.pareto_front_indices(thr, area, en)
    if on == "torch":
        pre = PORT.dse._front_prefilter(torch.as_tensor(thr),
                                        torch.as_tensor(area),
                                        torch.as_tensor(en)).numpy()
    else:
        pre = PORT.dse._front_prefilter(thr, area, en)
    assert np.unique(pre).size == pre.size
    assert set(front.tolist()) <= set(pre.tolist())
    pre = np.sort(pre)
    sub = pre[PORT.dse.pareto_front_indices(thr[pre], area[pre], en[pre])]
    assert np.array_equal(sub, front)
    pts = [PORT.dse.DesignPoint({}, {}, {}, t, a, e)
           for t, a, e in zip(thr, area, en)]
    brute = {id(p) for p in PORT.dse.pareto_front_bruteforce(pts)}
    assert {id(pts[i]) for i in sub} == brute


@pytest.mark.parametrize("seed", [0, 5])
def test_prefilter_equals_reference_function(seed):
    """Over NumPy the port's prefilter returns the reference's array (the
    same positions in the same order); over tensors the same set."""
    thr, area, en = _grid_objectives(seed, 300)
    want = REF.dse._front_prefilter(thr, area, en)
    assert np.array_equal(PORT.dse._front_prefilter(thr, area, en), want)
    got_t = PORT.dse._front_prefilter(torch.as_tensor(thr),
                                      torch.as_tensor(area),
                                      torch.as_tensor(en))
    assert np.array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("on", ["numpy", "torch"])
def test_prefilter_identity_fallback_and_empty(on):
    thr, area, en = _grid_objectives(7, 50)
    area = area + np.arange(50) * 1e-3              # 50 area classes
    conv = torch.as_tensor if on == "torch" else np.asarray
    got = PORT.dse._front_prefilter(conv(thr), conv(area), conv(en),
                                    max_classes=10)
    assert np.array_equal(np.asarray(got), np.arange(50))
    want = REF.dse._front_prefilter(thr, area, en, max_classes=10)
    assert np.array_equal(np.asarray(got), want)
    e = conv(np.empty(0))
    assert np.asarray(PORT.dse._front_prefilter(e, e, e)).shape == (0,)


GRIDS = {
    "single": (("gsm",), dict(ks=(1, 2, 4), acc_rates=(0.2, 0.6, 1.0),
                              noc_rates=(0.5, 1.0), n_tg=2)),
    "small_shared": (("dfsin", "gsm"), SMALL),
    "small_independent": (("dfsin", "gsm"),
                          dict(SMALL, island_rates="independent")),
    "all_collisions": (("dfsin", "gsm"), dict(
        ks=(1, 2), acc_rates=(1.0,), noc_rates=(1.0,),
        positions=((1, 1),), n_tg=0)),
}


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("key", list(GRIDS))
def test_dense_pareto_goes_through_the_prefilter(key, backend):
    names, kw = GRIDS[key]
    ref = REF.dse.grid_sweep(REF.pm.SoCPerfModel(), _wls(REF, names), **kw)
    got = PORT.dse.grid_sweep(PORT.pm.SoCPerfModel(), _wls(PORT, names),
                              **kw, device="cpu", backend=backend)
    if backend == "torch":
        # computed where the objectives were evaluated, then only used
        assert got.front_candidates is not None
        assert got.prefilter_s is not None and got.prefilter_s >= 0.0
        assert np.all(np.diff(got.front_candidates) > 0)
    else:
        assert got.front_candidates is None
    pf = got.pareto_indices()
    assert np.array_equal(pf, ref.pareto_indices())
    flat = np.nonzero(got.valid)[0]
    scan = flat[PORT.dse.pareto_front_indices(
        got.throughput[flat], got.area[flat], got.energy_per_unit[flat])]
    assert np.array_equal(pf, scan)


# ---------------------------------------------------- scalar sweep, text
@pytest.mark.parametrize("wl", ["dfadd", "gsm", "adpcm"])
def test_sweep_soc_equals_reference(wl):
    kw = dict(ks=(1, 2, 4), noc_rates=(0.1, 0.5, 1.0),
              positions=((1, 1), (3, 3), (0, 2)), n_tg=3)
    ref = REF.dse.sweep_soc(REF.pm.SoCPerfModel(), _wls(REF, (wl,))[0], **kw)
    got = PORT.dse.sweep_soc(PORT.pm.SoCPerfModel(), _wls(PORT, (wl,))[0],
                             **kw)
    assert len(got) == len(ref) == 81
    for p, q in zip(got, ref):
        assert (p.key(), p.throughput, p.area, p.energy_per_unit) == \
            (q.key(), q.throughput, q.area, q.energy_per_unit)
    assert PORT.dse.summarize(got) == REF.dse.summarize(ref)
    assert PORT.dse.summarize(got, top=3) == REF.dse.summarize(ref, top=3)


@pytest.mark.parametrize("chunk", [None, 101])
def test_summarize_result_strings_equal(chunk):
    kw = dict(SMALL, island_rates="independent", chunk_points=chunk)
    ref = REF.dse.grid_sweep(REF.pm.SoCPerfModel(), _wls(REF), **kw)
    got = PORT.dse.grid_sweep(PORT.pm.SoCPerfModel(), _wls(PORT), **kw,
                              device="cpu")
    got.elapsed_s = ref.elapsed_s           # the line carries points/s
    assert PORT.dse.summarize_result(got) == REF.dse.summarize_result(ref)
    assert PORT.dse.summarize_result(got, top=2) == \
        REF.dse.summarize_result(ref, top=2)


def test_sweep_replication_roofline_and_exports():
    def cell(k):
        return {"flops": 10.0 * k, "bytes": 3.0}
    assert PORT.dse.sweep_replication_roofline(cell) == \
        REF.dse.sweep_replication_roofline(cell)
    import repro_torch.core as core
    for name in ("sweep_soc", "summarize", "summarize_result",
                 "ChunkedSweepResult", "sweep_replication_roofline"):
        assert getattr(core, name) is getattr(PORT.dse, name)


# --------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chunked sweep's device half "
                    "is held against the host there (chip_smoke.py runs "
                    "this case on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode,chunk", [(m, c)
                                        for m in ("shared", "independent")
                                        for c in (17, 101, 430)])
def test_cuda_chunked_sweep_matches_host(mode, chunk, cuda_device):
    """The chunked sweep with mask, prefilter and top-k on the card against
    the host NumPy chunked sweep; the case runs in ``chip_smoke.py``
    (``card_chunked_sweep``)."""
    chip_smoke().card_case("test_cuda_chunked_sweep_matches_host", mode,
                           chunk)
