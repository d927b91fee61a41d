"""The port's examples on the CPU (``--device cpu``), held to the reference
package's examples.

* ``examples/torch_dse_sweep.py`` prints what ``examples/dse_sweep.py``
  prints, line for line, but for the timing figures (points/s, seconds).
* ``examples/torch_closed_loop.py --faults`` prints what
  ``examples/closed_loop.py --faults`` prints, line for line (the five
  replica-kill runs, the detection latency, the gate); ``--observe`` exits
  non-zero with the ROADMAP queue A item 9 refusal and prints no result.
* its pipeline scenario at the reference test's size (2,500 ticks) passes
  the gate the example asserts (``pipeline_gate``).
"""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMING = re.compile(r"[0-9,.]+ pts/s|in [0-9.]+s")


def _run(script, *args, pythonpath=False):
    env = dict(os.environ)
    if pythonpath:
        env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                        script), *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)


@pytest.mark.parametrize("args", [(), ("--accel", "dfmul")],
                         ids=["dfadd", "dfmul"])
def test_dse_sweep_example_prints_the_reference_output(args):
    ref = _run("dse_sweep.py", *args, pythonpath=True)
    port = _run("torch_dse_sweep.py", "--device", "cpu", *args)
    assert ref.returncode == 0 and port.returncode == 0, port.stderr
    assert TIMING.sub("", port.stdout) == TIMING.sub("", ref.stdout)


@pytest.mark.parametrize("knob,item", [("--faults", "8"),
                                       ("--observe", "9")])
def test_closed_loop_example_refuses_what_is_not_ported(knob, item):
    """``--observe`` (queue A item 9) is refused.  ``--faults`` (item 8) is
    ported: it runs the scenario gate and prints the reference example's
    output exactly."""
    out = _run("torch_closed_loop.py", "--device", "cpu", knob)
    if knob == "--faults":
        ref = _run("closed_loop.py", knob, pythonpath=True)
        assert ref.returncode == 0 and out.returncode == 0, out.stderr
        assert out.stdout == ref.stdout
        assert "acceptance: replica kill mid-surge survives" in out.stdout
        return
    assert out.returncode != 0
    assert f"not ported yet (ROADMAP queue A item {item})" in out.stderr
    assert out.stdout == ""


def test_closed_loop_example_pipeline_gate():
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import torch_closed_loop as ex
    finally:
        sys.path.pop(0)
    runs = ex.pipeline_runs(ex.pipeline_platform(),
                            ex.hotspot_trace(ticks=2500), device="cpu")
    sv_dfs, sv_lb = ex.pipeline_gate(runs)
    assert sv_dfs > 0.03 and sv_lb > 0.03
