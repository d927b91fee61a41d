"""Every ``gpu``-marked case runs on the card.

The card's machine has no jax, and the test files import it, so pytest
cannot run there.  ``chip_smoke.py`` keeps the case lists and the checks of
the gpu-marked tests (``CARD_TESTS``), runs all of them in its
``card_tests`` phase, and each gpu-marked test calls its case there.  This
test holds ``CARD_TESTS`` to exactly the gpu-marked tests of the files
that have them, with exactly their parameter cases.
"""
import inspect
import itertools

import pytest

import test_torch_dse_chunked
import test_torch_llm_kernels
import test_torch_moe
import test_torch_observe
import test_torch_sim_batch
import test_torch_sim_engine
import test_torch_sim_faults
import test_torch_ssd
import test_torch_telemetry
import test_torch_tick_sim

from _torch_port_helpers import chip_smoke

MODULES = (test_torch_llm_kernels, test_torch_ssd, test_torch_tick_sim,
           test_torch_dse_chunked, test_torch_telemetry, test_torch_sim_batch,
           test_torch_sim_engine, test_torch_sim_faults, test_torch_observe,
           test_torch_moe)


def _gpu_tests():
    """name -> the set of its cases, each a tuple of its arguments in its
    signature's order (the card fixture left out)."""
    out = {}
    for mod in MODULES:
        for name, fn in vars(mod).items():
            marks = getattr(fn, "pytestmark", [])
            if not name.startswith("test_") or not any(
                    m.name == "gpu" for m in marks):
                continue
            axes = []
            for m in marks:
                if m.name != "parametrize":
                    continue
                names, values = m.args[0], m.args[1]
                names = [n.strip() for n in names.split(",")]
                axes.append([dict(zip(names, v if len(names) > 1 else (v,)))
                             for v in values])
            params = [p for p in inspect.signature(fn).parameters
                      if p != "cuda_device"]
            cases = set()
            for combo in itertools.product(*axes):
                merged = {k: v for d in combo for k, v in d.items()}
                cases.add(tuple(merged[p] for p in params))
            out[name] = cases
    return out


def test_every_gpu_case_is_a_card_case():
    cs = chip_smoke()
    gpu = _gpu_tests()
    assert len(gpu) >= 18
    assert set(gpu) == set(cs.CARD_TESTS)
    for name, cases in gpu.items():
        assert cases == set(cs.CARD_TESTS[name][1]), name


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__)
def test_gpu_tests_call_their_card_case(module):
    """Each gpu-marked test hands its case to ``card_case`` under its own
    name, so what runs under pytest is what runs on the card."""
    for name, fn in vars(module).items():
        if name.startswith("test_") and any(
                m.name == "gpu" for m in getattr(fn, "pytestmark", [])):
            src = "".join(inspect.getsource(fn).split())
            assert f'card_case("{name}"' in src, name


def test_card_phase_runs_every_card_test():
    """``phase_card_tests`` walks CARD_TESTS, and ``main`` runs it before
    the quick exit."""
    cs = chip_smoke()
    assert "CARD_TESTS.items()" in inspect.getsource(cs.phase_card_tests)
    main = inspect.getsource(cs.main)
    assert main.index("phase_card_tests()") < main.index("if args.quick")
