"""The port's examples on the CPU (``--device cpu``), held to the reference
package's examples.

* ``examples/torch_dse_sweep.py`` prints what ``examples/dse_sweep.py``
  prints, line for line, but for the timing figures (points/s, seconds).
* ``examples/torch_closed_loop.py --faults`` and ``--observe`` print what
  ``examples/closed_loop.py --faults`` / ``--observe`` print, line for line
  (the five replica-kill runs, the detection latency, the gate; the
  zero-perturbation check, the counter plane's roll-up, the decision trace,
  the Prometheus export).
* its pipeline scenario at the reference test's size (2,500 ticks) passes
  the gate the example asserts (``pipeline_gate``).
* ``examples/torch_train_100m.py`` (the ~100M danube-family config of
  ``examples/train_100m.py``) at a few steps and a short sequence: its
  mid-run DFS reconfiguration, the simulated failure and the recovery.
* ``examples/torch_quickstart.py`` prints what ``examples/quickstart.py``
  prints but for the next tokens (the weights are random and each package
  draws its own) and the monitor's wall time;
  ``examples/torch_serve_batched.py`` prints exactly what
  ``examples/serve_batched.py`` prints (the schedule does not depend on the
  weights).
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
    """``--faults`` (queue A item 8) and ``--observe`` (item 9) are both
    ported: each runs its scenario (the gate; the zero-perturbation check)
    and prints the reference example's output exactly."""
    out = _run("torch_closed_loop.py", "--device", "cpu", knob)
    ref = _run("closed_loop.py", knob, pythonpath=True)
    assert ref.returncode == 0 and out.returncode == 0, out.stderr
    assert out.stdout == ref.stdout
    assert {"--faults": "acceptance: replica kill mid-surge survives",
            "--observe": "zero-perturbation: observed run == unobserved "
                         "run"}[knob] in out.stdout


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


def test_train_100m_example_recovers(tmp_path):
    out = _run("torch_train_100m.py", "--device", "cpu", "--steps", "4",
               "--seq-len", "32", "--batch", "2", "--ckpt-every", "2",
               "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "training 80M params for 4 steps"
    assert "DFS: derating memory-bound islands (hitless commit next step)" \
        in lines
    assert "recovered at step 2" in lines
    steps = [int(ln.split()[1]) for ln in lines if ln.startswith("  step")]
    assert steps == [1, 2, 3, 4]       # 1-2, then 3-4 after the recovery
    assert any(ln.startswith("loss: ") for ln in lines)


WEIGHT_BOUND = re.compile(r"next tokens \[[0-9, ]+\]|t=[0-9.]+")


def _run_pair(ref_script, port_script):
    """The reference example and the port's (``--device cpu``) run side by
    side: (reference, port) ``CompletedProcess``es."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", script), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=e,
        cwd=ROOT) for script, args, e in (
            (ref_script, (), env), (port_script, ("--device", "cpu"),
                                    dict(os.environ)))]
    out = []
    for p in procs:
        o, e = p.communicate(timeout=300)
        out.append(subprocess.CompletedProcess(p.args, p.returncode, o, e))
    return out


def test_quickstart_example_prints_the_reference_output():
    ref, port = _run_pair("quickstart.py", "torch_quickstart.py")
    assert ref.returncode == 0 and port.returncode == 0, port.stderr
    assert WEIGHT_BOUND.sub("", port.stdout) == \
        WEIGHT_BOUND.sub("", ref.stdout)
    assert re.search(r"next tokens \[[0-9]+, [0-9]+\]", port.stdout)


def test_serve_batched_example_prints_the_reference_output():
    ref, port = _run_pair("serve_batched.py", "torch_serve_batched.py")
    assert ref.returncode == 0 and port.returncode == 0, port.stderr
    assert port.stdout == ref.stdout
    assert port.stdout.startswith("completed 8/8 requests")
