"""The port's linter (``repro_torch.analysis``) analysed: fixture snippets
per TPR rule (positive, negative, noqa), the noqa without a justification,
the differential against the reference linter (``repro.analysis``) on the
same inputs — the findings machinery on the reference tests' own fixture
texts, TPR003's raw findings against RPR003's over both packages and the
reference's fixtures, TPR006's matrix against RPR006's — seeded mutations
of real port sources in ``tmp_path`` copies (each must fire its rule, each
unmutated copy is clean), the CLI gate against the committed
``analysis/baseline_torch.json``, the ``compat`` shims, and the matching
``chip_smoke.py``'s ``analysis`` phase does between the syncs it observes
and the rule's lines.
"""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import engine as ref_engine
from repro.analysis import findings as ref_findings
from repro.analysis.rules import rpr003_cache_bounds as ref_rpr003
from repro.analysis.rules import rpr006_parity as ref_rpr006
from repro_torch import compat
from repro_torch.analysis import (analyze_paths, findings, load_baseline,
                                  save_baseline)
from repro_torch.analysis.engine import load_modules
from repro_torch.analysis.rules import RULES, get_rules
from repro_torch.analysis.rules import tpr003_cache_bounds as tpr003
from repro_torch.analysis.rules import tpr006_parity as tpr006

from _torch_port_helpers import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
REF_TESTS = ROOT / "tests" / "test_analysis.py"


def run_on(tmp_path, sources, rules=None, baseline=None):
    """Write {relpath: source} under tmp_path and analyze them all."""
    paths = []
    for rel, src in sources.items():
        f = tmp_path / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(src)
        paths.append(f)
    return analyze_paths(paths, root=tmp_path, baseline=baseline,
                         rules=get_rules(rules) if rules else None)


def by_rule(report, rule):
    return [f for f in report.new if f.rule == rule]


# ---------------------------------------------------------------- TPR001
TPR001_POS = """\
import torch

def tick(x: torch.Tensor, mask: torch.Tensor):  # repro: hot
    t = torch.zeros(3)
    a = x.item()
    if t.sum() > 0:
        a = 1
    b = float(t)
    torch.cuda.synchronize()
    idx = torch.nonzero(mask)
    sel = x[x > 0]
    c = t.cpu()
    d = t.to("cpu")
    e = torch.repeat_interleave(x, t)
    f = torch.bincount(x)
    g = t.tolist()
    return a, b, idx, sel, c, d, e, f, g
"""

TPR001_NEG = """\
import numpy as np
import torch

def tick(x: torch.Tensor, n: int, cfg, arr):  # repro: hot
    y = torch.zeros(3, device=x.device)
    if x.shape[0] > 1:            # a shape: a Python int
        y = y + 1
    if x is None or n > 2:        # identity, an int
        return y
    if isinstance(n, int):
        n = int(n)                # an int stays on the host
    h = np.nonzero(arr)[0]        # NumPy: the host's own
    rows = h.tolist()
    y2 = torch.where(y > 0, y, -y)   # branch done on the card
    z = torch.repeat_interleave(y, 2, output_size=6)
    return y2, rows, z

def cold(x: torch.Tensor):        # not hot: may read the card
    return x.item()
"""


def test_tpr001_fires_on_each_host_sync_in_a_hot_function(tmp_path):
    rep = run_on(tmp_path, {"s.py": TPR001_POS}, rules=["TPR001"])
    msgs = " | ".join(f.message for f in by_rule(rep, "TPR001"))
    for what in ("`.item()`", "Python `if`", "float()",
                 "`torch.cuda.synchronize`", "`torch.nonzero`",
                 "boolean-mask", "`.cpu()`", '`.to("cpu")`',
                 "`repeat_interleave`", "`torch.bincount`", "`.tolist()`"):
        assert what in msgs, what
    assert len(by_rule(rep, "TPR001")) == 11


def test_tpr001_quiet_on_static_idioms_and_cold_functions(tmp_path):
    rep = run_on(tmp_path, {"s.py": TPR001_NEG}, rules=["TPR001"])
    assert by_rule(rep, "TPR001") == []


def test_tpr001_noqa_suppresses_with_justification(tmp_path):
    src = TPR001_POS.replace(
        "    a = x.item()",
        "    a = x.item()  # repro: noqa[TPR001] one read a run")
    rep = run_on(tmp_path, {"s.py": src}, rules=["TPR001"])
    assert not any(".item()" in f.message for f in by_rule(rep, "TPR001"))
    sup = [f for f in rep.suppressed if f.rule == "TPR001"]
    assert sup and sup[0].justification == "one read a run"


def test_noqa_without_justification_is_tpr000(tmp_path):
    src = TPR001_POS.replace("    a = x.item()",
                             "    a = x.item()  # repro: noqa[TPR001]")
    rep = run_on(tmp_path, {"s.py": src}, rules=["TPR001"])
    assert any(f.rule == "TPR000" and "justification" in f.message
               for f in rep.new)


def test_tpr001_hot_scope_crosses_modules(tmp_path):
    """The decode shape: the entry calls into another module of the
    package, whose host read is the finding."""
    srcs = {"pkg/__init__.py": "",
            "pkg/entry.py": (
                "from pkg import layers as L\n"
                "from pkg.helpers import helper\n"
                "def step(x):  # repro: hot\n"
                "    y = L.attend(x)\n"
                "    return helper(y)\n"),
            "pkg/layers.py": (
                "import torch\n"
                "def attend(x):\n"
                "    return torch.relu(x)\n"),
            "pkg/helpers.py": (
                "def helper(y):\n"
                "    return y.item()\n"
                "def unused(y):\n"
                "    return y.item()\n")}
    rep = run_on(tmp_path, srcs, rules=["TPR001"])
    hits = by_rule(rep, "TPR001")
    assert [(f.path, f.line) for f in hits] == [("pkg/helpers.py", 2)]
    assert "called from step" in hits[0].message


def test_tpr001_loop_entry_holds_only_its_loop(tmp_path):
    """A loop entry (grid_sweep's block loop): the loop's syncs are
    findings, the function's others are not."""
    src = ("import torch\n"
           "def grid_sweep(xs):\n"
           "    n = torch.tensor(3).item()\n"
           "    for o0 in range(n):\n"
           "        xs[o0].cpu()\n"
           "    return torch.zeros(1).tolist()\n")
    rep = run_on(tmp_path, {"core/dse.py": src}, rules=["TPR001"])
    assert [f.line for f in by_rule(rep, "TPR001")] == [5]


PART_ENTRIES = {
    # BatchSimEngine._loop by its call of the tick loop: the set-up before
    # it and the summary after it are not hot, the tick loop is
    "call": ("sim/batch.py", """\
import torch

class BatchSimEngine:
    def _loop(self, x: torch.Tensor):
        n = x.sum().item()
        self._ticks(x)
        return x.cpu()

    def _ticks(self, x: torch.Tensor):
        return x.tolist()

    def _summary(self, x: torch.Tensor):
        return x.item()
""", [10]),
    # SimEngine.run by its control closure: what the closure does each
    # control tick is hot, the run's own reads after the loop are not
    "nested": ("sim/engine.py", """\
import torch

class SimEngine:
    def run(self, x: torch.Tensor):
        n = x.sum().item()

        def control(t_i, window: torch.Tensor):
            return window.cpu()
        self.eng._loop(x, control)
        return x.tolist()
""", [8]),
}


@pytest.mark.parametrize("form", sorted(PART_ENTRIES))
def test_tpr001_part_entry_holds_only_its_part(tmp_path, form):
    """An entry declared by the part of it that runs per tick (a call of
    the tick loop, a closure the loop calls back): only that part is hot."""
    path, src, lines = PART_ENTRIES[form]
    rep = run_on(tmp_path, {path: src}, rules=["TPR001"])
    assert [f.line for f in by_rule(rep, "TPR001")] == lines


def test_engines_setup_and_summaries_are_not_hot():
    """On the port: the engines' set-up and the reads after their loops lie
    outside the hot scope, the tick loop and the control closure inside."""
    hot = {r.qualname: i for r, i in
           load_modules([PKG], ROOT)[0].hotindex.hot.items()}
    assert "SimEngine.run.control" in hot and "SimEngine.run" not in hot
    assert hot["BatchSimEngine._loop"].region is not None
    assert "BatchSimEngine._ticks" in hot
    for cold in ("TelemetryRings.to_telemetry", "TelemetryRings.to_host",
                 "BatchSimEngine._host_summary", "latency_percentiles_batch",
                 "SimEngine._emit_trace"):
        assert cold not in hot, cold


# ---------------------------------------------------------------- TPR002
MEMO = """\
import torch

class Eng:
    def __init__(self):
        self._dev = {{}}

    def layout(self, device, dtype):
        key = {key}
        if key not in self._dev:
            self._dev[key] = torch.zeros(3, dtype=dtype, device=device)
        return self._dev[key]
"""

DIGEST = """\
import hashlib
from pathlib import Path

CSRC = Path(".")

def _target(src, flags):
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(flags).encode())
    return Path("b") / f"lib_{{h.hexdigest()[:16]}}.so"

def build(src, extra):
    flags = ("-O3",) + extra
    so = _target(src, {keyed})
    _start(src, so, flags)

def _start(src, so, flags):
    pass
"""


def test_tpr002_flags_a_value_input_missing_from_the_key(tmp_path):
    rep = run_on(tmp_path, {"s.py": MEMO.format(key="device")},
                 rules=["TPR002"])
    hits = by_rule(rep, "TPR002")
    assert len(hits) == 1 and "`dtype`" in hits[0].message


def test_tpr002_quiet_when_the_key_is_complete(tmp_path):
    rep = run_on(tmp_path, {"s.py": MEMO.format(key="(device, dtype)")},
                 rules=["TPR002"])
    assert by_rule(rep, "TPR002") == []


def test_tpr002_content_key_must_digest_what_the_build_reads(tmp_path):
    ok = run_on(tmp_path, {"kernels/build.py": DIGEST.format(keyed="flags")},
                rules=["TPR002"])
    assert by_rule(ok, "TPR002") == []
    bad = run_on(tmp_path, {"kernels/build.py": DIGEST.format(
        keyed='("-O3",)')}, rules=["TPR002"])
    assert any("`flags`" in f.message for f in by_rule(bad, "TPR002"))


def test_tpr002_noqa(tmp_path):
    src = MEMO.format(key="device").replace(
        "            self._dev[key] = torch.zeros(3, dtype=dtype, "
        "device=device)",
        "            self._dev[key] = torch.zeros(3, dtype=dtype, "
        "device=device)  # repro: noqa[TPR002] one dtype an engine")
    rep = run_on(tmp_path, {"s.py": src}, rules=["TPR002"])
    assert by_rule(rep, "TPR002") == [] and rep.suppressed


# ---------------------------------------------------------------- TPR003
def _ref_rpr003_fixtures():
    """The string fixtures of ``tests/test_analysis.py``'s RPR003 tests."""
    tree = ast.parse(REF_TESTS.read_text())
    out = []
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and \
                fn.name.startswith("test_rpr003"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Constant) and \
                        isinstance(node.value.value, str):
                    out.append(node.value.value)
    assert len(out) == 2
    return out


def test_tpr003_fixtures_positive_negative_noqa(tmp_path):
    pos, neg = _ref_rpr003_fixtures()
    rep = run_on(tmp_path, {"s.py": pos}, rules=["TPR003"])
    msgs = " | ".join(f.message for f in by_rule(rep, "TPR003"))
    for what in ("_CACHE", "maxsize=None", "functools.cache", "self.memo"):
        assert what in msgs
    assert by_rule(run_on(tmp_path, {"s.py": neg}, rules=["TPR003"]),
                   "TPR003") == []
    quiet = pos.replace("_CACHE = {}\n", "_CACHE = {}  # repro: noqa"
                        "[TPR003] registry bounded by source\n")
    rep = run_on(tmp_path, {"s.py": quiet}, rules=["TPR003"])
    assert "_CACHE" not in " | ".join(f.message
                                      for f in by_rule(rep, "TPR003"))


def _raw_pairs(mod, load, paths, root):
    """(path, line, message) of one rule's raw findings."""
    out = set()
    for p in paths:
        for f in sorted(p.rglob("*.py")) if p.is_dir() else [p]:
            if "__pycache__" in f.parts:
                continue
            ctx = load(f, root)
            if ctx is not None:
                out |= {(x.path, x.line, x.message) for x in mod.check(ctx)}
    return out


@pytest.mark.parametrize("where", ["src/repro_torch", "src/repro",
                                   "fixtures"])
def test_tpr003_raw_findings_equal_rpr003(where, tmp_path):
    if where == "fixtures":
        paths = []
        for i, src in enumerate(_ref_rpr003_fixtures()):
            f = tmp_path / f"fixture{i}.py"
            f.write_text(src)
            paths.append(f)
        root = tmp_path
    else:
        paths, root = [ROOT / where], ROOT
    ref = _raw_pairs(ref_rpr003, ref_engine.load_module, paths, root)
    port = _raw_pairs(tpr003, lambda f, r: load_modules([f], r)[0],
                      paths, root)
    assert ref == port and ref
    if where == "src/repro_torch":
        named = {(p.split("repro_torch/")[1], re.search(r"`([^`]+)`",
                                                        m).group(1))
                 for p, _, m in port}
        for want in [("configs/base.py", "_REGISTRY"),
                     ("kernels/_common.py", "_SM_COUNT"),
                     ("kernels/build.py", "_libs"),
                     ("kernels/build.py", "last_build_seconds"),
                     ("kernels/build.py", "last_build_log"),
                     ("kernels/fused_mlp.py", "_COUNTERS"),
                     ("sim/batch.py", "self._dev_cache"),
                     ("sim/control.py", "self._dev")]:
            assert want in named, want
        # bounded in the port since the linter found it
        assert ("parallel/placement.py", "_MESHES") not in named


# ---------------------------------------------------------------- TPR004
def test_tpr004_float32_in_the_reference_set_fires(tmp_path):
    src = ("import torch\n"
           "def run(x):\n"
           "    return torch.zeros(3, dtype=torch.float32)\n"
           "def cast(x, dtype=torch.float64):\n"
           "    return x.to(torch.float32)   # its caller's dtype\n")
    rep = run_on(tmp_path, {"sim/engine.py": src}, rules=["TPR004"])
    assert [f.line for f in by_rule(rep, "TPR004")] == [3]
    assert by_rule(run_on(tmp_path, {"other.py": src}, rules=["TPR004"]),
                   "TPR004") == []


def test_tpr004_float64_on_a_device_path_fires(tmp_path):
    src = ("import numpy as np\n"
           "import torch\n"
           "def up(x):\n"
           "    return torch.zeros(3, dtype=torch.float64)\n"
           "def up2(x):\n"
           "    return x.double()\n"
           "def stage(x):\n"
           "    return np.asarray(x, dtype=np.float64)  # host: fine\n")
    rep = run_on(tmp_path, {"models/layers.py": src}, rules=["TPR004"])
    assert [f.line for f in by_rule(rep, "TPR004")] == [4, 6]
    noqa = src.replace("    return x.double()\n", "    return x.double()"
                       "  # repro: noqa[TPR004] a float64 check\n")
    rep = run_on(tmp_path, {"models/layers.py": noqa}, rules=["TPR004"])
    assert [f.line for f in by_rule(rep, "TPR004")] == [4]


# ---------------------------------------------------------------- TPR005
WRAPPER = """\
from repro_torch.kernels._common import on_card, refuse_counting, \\
    refuse_grad

_FN = None


def thing_plain(x):
    return x


def _launch(x):
    global _FN
    if _FN is None:
        from repro_torch.kernels import build
        _FN = build.function("thing", "thing_launch", [])
    _FN(x.data_ptr())
    return x


def thing(x):
    if on_card(x):
        refuse_grad("thing", x)
        refuse_counting("thing")
        return _launch(x)
    return thing_plain(x)
"""


def test_tpr005_idiomatic_wrapper_passes(tmp_path):
    rep = run_on(tmp_path, {"kernels/flash_attention.py": WRAPPER},
                 rules=["TPR005"])
    assert by_rule(rep, "TPR005") == []


@pytest.mark.parametrize("mutate,what", [
    (lambda s: s.replace('        refuse_counting("thing")\n', ""),
     "refuse_counting"),
    (lambda s: s.replace("        return _launch(x)\n    return thing_plain"
                         "(x)\n", "        return thing_plain(x)\n    "
                         "return _launch(x)\n"), "outside `if on_card"),
    (lambda s: s + "\n_LIB = _launch(None)\n", "import time"),
    (lambda s: s.replace("    _FN(x.data_ptr())\n",
                         "    _FN(x.data_ptr())\n    x.sum().item()\n"),
     "host sync"),
])
def test_tpr005_each_wrapper_rule_fires(tmp_path, mutate, what):
    rep = run_on(tmp_path, {"kernels/flash_attention.py": mutate(WRAPPER)},
                 rules=["TPR005"])
    assert any(what in f.message for f in by_rule(rep, "TPR005")), \
        [f.message for f in rep.new]


def test_tpr005_noqa(tmp_path):
    src = WRAPPER.replace('        refuse_grad("thing", x)\n', "").replace(
        "def thing(x):\n", "def thing(x):  # repro: noqa[TPR005] no grad "
        "can reach it\n")
    rep = run_on(tmp_path, {"kernels/flash_attention.py": src},
                 rules=["TPR005"])
    assert by_rule(rep, "TPR005") == [] and rep.suppressed


# ---------------------------------------------------------------- TPR006
FAKE_ENGINE = """\
class SimEngine:
    def __init__(self, platform, *, config=None, controller=None,
                 balancer=None, faults=None, slo=None, supervisor=None,
                 tech=None, observe=None, device=None):
        pass
"""

FAKE_BATCH = """\
class BatchSimEngine:
    def __init__(self, platform, *, config=None, controller=None,
                 balancer=None, backend="torch", faults=None, slo=None,
                 observe=None, devices=None, tech=None, device=None):
        pass

    def _refuse_unported(self):
        raise NotImplementedError("fused backend: no fault schedules")
        raise NotImplementedError("fused backend: no SLO semantics")
        raise NotImplementedError("fused backend: no load balancer")
        raise NotImplementedError("fused backend: no observer plane")
"""

FAKE_DSE = """\
def closed_loop_score(result, trace, *, model, backend=None,
                      flows=None, balancer_factory=None,
                      fault_schedule=None, slo=None, observe=None,
                      devices=None, tech=None, device=None):
    pass


def grid_sweep(model, *, backend=None, devices=None,
               tech_node=None, tech_variant=None, device=None):
    pass
"""


def _fake_surfaces():
    return {"sim/engine.py": FAKE_ENGINE, "sim/batch.py": FAKE_BATCH,
            "core/dse.py": FAKE_DSE}


def test_tpr006_parity_matrix_green_on_full_surfaces(tmp_path):
    rep = run_on(tmp_path, _fake_surfaces(), rules=["TPR006"])
    assert by_rule(rep, "TPR006") == []


@pytest.mark.parametrize("path,old,new,what", [
    ("sim/engine.py", "observe=None", "obs=None",
     "must accept knob `observe`"),
    ("sim/engine.py", "observe=None, device", "observe=None, backend=None, "
     "device", "declares absent"),
    ("sim/batch.py", '        raise NotImplementedError("fused backend: '
     'no observer plane")\n', "", "observer plane"),
    ("sim/batch.py", "fused backend: no load", "no load", "load balancer"),
])
def test_tpr006_drift_fires(tmp_path, path, old, new, what):
    srcs = _fake_surfaces()
    srcs[path] = srcs[path].replace(old, new)
    rep = run_on(tmp_path, srcs, rules=["TPR006"])
    assert any(what in f.message for f in by_rule(rep, "TPR006"))


def test_tpr006_noqa(tmp_path):
    srcs = _fake_surfaces()
    srcs["sim/engine.py"] = FAKE_ENGINE.replace("observe=None", "obs=None"
                                                ).replace(
        "    def __init__(self, platform, *, config=None, controller=None,",
        "    def __init__(self, platform, *, config=None, controller=None,"
        "  # repro: noqa[TPR006] observed elsewhere")
    rep = run_on(tmp_path, srcs, rules=["TPR006"])
    assert by_rule(rep, "TPR006") == [] and rep.suppressed


def test_tpr006_matrix_is_the_references_with_backends_mapped():
    """Knob for knob, surface for surface, the reference's RPR006 matrix
    (read from ``src/repro/analysis/rules/rpr006_parity.py``) with its
    backends mapped to the port's."""
    def mapped(v):
        return tpr006.BACKEND_MAP.get(v, v) if isinstance(v, str) else v
    assert tpr006.KNOB_ALIASES == ref_rpr006.KNOB_ALIASES
    assert [(s, q, {k: mapped(v) for k, v in spec.items()})
            for s, q, spec in ref_rpr006.PARITY] == list(tpr006.PARITY)
    assert list(ref_rpr006.REQUIRED_REFUSALS) == \
        list(tpr006.REQUIRED_REFUSALS)
    assert set(tpr006.BACKEND_MAP) == {"numpy", "pallas"}


def test_reference_rpr006_is_silent_on_the_port_surfaces():
    paths = [PKG / "sim" / "engine.py", PKG / "sim" / "batch.py",
             PKG / "core" / "dse.py"]
    rep = ref_engine.analyze_paths(paths, root=ROOT, rules=[ref_rpr006])
    assert [f for f in rep.new if f.rule == "RPR006"] == []
    port = analyze_paths(paths, root=ROOT, rules=get_rules(["TPR006"]))
    assert port.new == []


# ------------------------------------------------ the findings machinery
def _ref_fixture_texts():
    """Every string fixture of ``tests/test_analysis.py``, with the noqa
    variants its tests write."""
    tree = ast.parse(REF_TESTS.read_text())
    texts = [n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and "\n" in n.value]
    base = [t for t in texts if "def " in t or "class " in t]
    pos = next(t for t in base if t.startswith("import jax\n") and
               "if x > 0:" in t and "float(x)" in t)
    return base + [
        pos.replace("    if x > 0:", "    if x > 0:  # repro: noqa[RPR001] "
                    "debug-only host branch"),
        pos.replace("    if x > 0:", "    if x > 0:  # repro: noqa[RPR001]"),
        'def f():\n    """# repro: noqa[RPR001] not a comment"""\n'
        "    return 1  # repro: noqa[RPR003] real comment\n",
        "x = 1  # repro: noqa[RPR001, RPR003] two ids\n"]


def test_findings_machinery_equals_the_references_on_its_fixtures():
    texts = _ref_fixture_texts()
    assert len(texts) >= 10
    for text in texts:
        ref_c = ref_findings.extract_comments(text)
        assert findings.extract_comments(text) == ref_c
        for c in ref_c.values():
            assert findings.parse_noqa(c) == ref_findings.parse_noqa(c)
        for i, line in enumerate(text.splitlines()):
            for rule in ("RPR001", "RPR003"):
                assert findings.fingerprint(rule, "a.py", line, i) == \
                    ref_findings.fingerprint(rule, "a.py", line, i)


def test_baseline_round_trips_between_the_two_linters(tmp_path):
    rows = [findings.Finding("TPR001", "a.py", 3, "m", "ab12cd34ef56ab78"),
            findings.Finding("TPR003", "b.py", 9, "n", "0123456789abcdef")]
    save_baseline(tmp_path / "port.json", rows)
    assert ref_findings.load_baseline(tmp_path / "port.json") == \
        {f.fingerprint for f in rows}
    ref_rows = [ref_findings.Finding(f.rule, f.path, f.line, f.message,
                                     f.fingerprint) for f in rows]
    ref_findings.save_baseline(tmp_path / "ref.json", ref_rows)
    assert (tmp_path / "ref.json").read_text() == \
        (tmp_path / "port.json").read_text()
    assert load_baseline(tmp_path / "ref.json") == \
        {f.fingerprint for f in rows}
    (tmp_path / "bad.json").write_text(json.dumps({"version": 9}))
    with pytest.raises(ValueError):
        load_baseline(tmp_path / "bad.json")


def test_fingerprint_stable_across_line_shifts(tmp_path):
    rep1 = run_on(tmp_path, {"a.py": TPR001_POS}, rules=["TPR001"])
    shifted = "# a leading comment\nX = 1\n\n" + TPR001_POS
    rep2 = run_on(tmp_path, {"a.py": shifted}, rules=["TPR001"])
    fp1 = sorted(f.fingerprint for f in rep1.new)
    fp2 = sorted(f.fingerprint for f in rep2.new)
    assert fp1 == fp2 and all(fp1)


# -------------------------------------------- mutations of real sources
@pytest.fixture(scope="module")
def tree_copy(tmp_path_factory):
    """A copy of ``src/repro_torch`` (paths relative to the copy's root as
    in the checkout, so the committed baseline applies)."""
    root = tmp_path_factory.mktemp("port")
    shutil.copytree(PKG, root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _baseline():
    return load_baseline(ROOT / "analysis" / "baseline_torch.json")


def _mutated(root, rel, old, new, tmp_path):
    """A second copy of the tree with ``rel`` mutated (``old`` must be in
    the source once)."""
    dst = tmp_path / "mut"
    shutil.copytree(root / "src", dst / "src")
    f = dst / "src" / "repro_torch" / rel
    src = f.read_text()
    assert src.count(old) == 1, old
    f.write_text(src.replace(old, new))
    return dst, f


def test_a_checkout_under_a_build_directory_is_analysed(tmp_path):
    """The skipped directories (``build``, ``__pycache__``, ...) are those
    below the path given: a checkout unpacked under ``build/`` is linted
    whole."""
    from repro_torch.analysis import iter_python_files
    pkg = tmp_path / "build" / "co" / "src" / "pkg"
    (pkg / "build").mkdir(parents=True)
    (pkg / "a.py").write_text("X = 1\n")
    (pkg / "build" / "gen.py").write_text("Y = 2\n")
    assert [f.name for f in iter_python_files([pkg])] == ["a.py"]


def test_unmutated_copy_is_clean(tree_copy):
    rep = analyze_paths([tree_copy / "src" / "repro_torch"], root=tree_copy,
                        baseline=_baseline())
    assert rep.new == [], [f"{f.location()} {f.message}" for f in rep.new]
    assert len(rep.baselined) == len(_baseline())


MUTATIONS = {
    "refuse_grad": (
        "kernels/flash_attention.py", "TPR005",
        '        refuse_grad("flash_attention", q, k, v)\n', "",
        "refuse_grad"),
    "fallback": (
        "kernels/flash_attention.py", "TPR005",
        "        return _launch(q, k, v, qpos, kpos, window, scale)\n",
        "        try:\n"
        "            return _launch(q, k, v, qpos, kpos, window, scale)\n"
        "        except RuntimeError:\n"
        "            return flash_attention_plain(q, k, v, qpos, kpos, "
        "window, scale)\n", "falls back" "|handler runs the plain"),
    "ticks_item": (
        "sim/batch.py", "TPR001",
        "            arr = lp.arrivals[t_i]\n",
        "            arr = lp.arrivals[t_i]\n"
        "            _ = arr.sum().item()\n", "BatchSimEngine._ticks"),
    "refusal": (
        "sim/batch.py", "TPR006",
        '            raise NotImplementedError(\n'
        '                "fused backend records no observer plane; "\n'
        "                \"use backend='torch'\")\n", "            pass\n",
        "observer plane"),
    "f32_in_f64": (
        "core/dse.py", "TPR004",
        "    dev = torch.device(device)\n    A = lay.A\n",
        "    dev = torch.device(device)\n    A = lay.A\n"
        "    _ = torch.zeros(1, dtype=torch.float32)\n", "float32"),
    "header_hash": (
        "kernels/build.py", "TPR002",
        '    for hdr in sorted(CSRC.glob("*.cuh")):      # any source may '
        'include it\n        h.update(hdr.name.encode())\n'
        "        h.update(hdr.read_bytes())\n", "", "*.cuh"),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_seeded_mutation_fires_its_rule(name, tree_copy, tmp_path):
    rel, rule, old, new, what = MUTATIONS[name]
    root, f = _mutated(tree_copy, rel, old, new, tmp_path)
    # TPR006 reads three surfaces at once; the others one module
    paths = ([root / "src" / "repro_torch" / p for p in (
        "sim/engine.py", "sim/batch.py", "core/dse.py")]
             if rule == "TPR006" else [f])
    rep = analyze_paths(paths, root=root, baseline=_baseline(),
                        rules=get_rules([rule]))
    hits = by_rule(rep, rule)
    assert any(re.search(what.replace("*", r"\*").replace("`", ""),
                         h.message.replace("`", "")) for h in hits), \
        [h.message for h in rep.new]
    clean = analyze_paths([tree_copy / "src" / "repro_torch" / p
                           for p in ([rel] if rule != "TPR006" else
                                     ["sim/engine.py", "sim/batch.py",
                                      "core/dse.py"])],
                          root=tree_copy, baseline=_baseline(),
                          rules=get_rules([rule]))
    assert by_rule(clean, rule) == []


def test_seeded_host_sync_in_the_decode_layers_fires_across_modules(
        tree_copy, tmp_path):
    """``.item()`` in ``layers.gqa_decode``, which ``LM.decode_step``
    reaches only through ``transformer.py``: TPR001 must find it."""
    root, _ = _mutated(
        tree_copy, "models/layers.py",
        "    kpos = ring_kpos(pos, W)\n    window = cfg.sliding_window",
        "    kpos = ring_kpos(pos, W)\n    _ = kpos.max().item()\n"
        "    window = cfg.sliding_window", tmp_path)
    rep = analyze_paths([root / "src" / "repro_torch"], root=root,
                        baseline=_baseline(), rules=get_rules(["TPR001"]))
    hits = by_rule(rep, "TPR001")
    assert len(hits) == 1 and hits[0].path.endswith("models/layers.py")
    assert "gqa_decode" in hits[0].message and ".item()" in hits[0].message


# ------------------------------------------------------------ CLI / gate
def _cli(*args, cwd=ROOT):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=300)


def test_cli_self_check_json_and_bench_against_committed_baseline():
    """``python -m repro_torch.analysis src/repro_torch --format json
    --bench`` exits 0 for the repository as committed (the CI gate) and
    imports no torch while it lints."""
    proc = _cli("src/repro_torch", "--format", "json", "--bench")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["counts"]["new"] == 0 and doc["bench"] == []
    assert doc["modules"] > 80 and doc["counts"]["baselined"] >= 1


def test_cli_exits_nonzero_on_a_new_finding(tmp_path):
    (tmp_path / "bad.py").write_text(TPR001_POS)
    proc = _cli(str(tmp_path / "bad.py"), "--baseline", "none")
    assert proc.returncode == 1
    assert "TPR001" in proc.stdout


def test_every_rule_module_declares_id_and_summary():
    ids = [m.RULE_ID for m in RULES]
    assert ids == [f"TPR00{i}" for i in range(1, 7)]
    for m in RULES:
        assert m.SUMMARY
        assert callable(getattr(m, "check", None)) or \
            callable(getattr(m, "check_project", None))
    with pytest.raises(ValueError):
        get_rules(["TPR999"])


def test_bench_reads_only_the_ports_trajectories(tmp_path):
    from repro_torch.analysis.bench import check_trajectories
    (tmp_path / "BENCH_sim.json").write_text(json.dumps(
        [{"gate": {"pass": False}}]))
    assert check_trajectories(tmp_path) == []
    (tmp_path / "BENCH_torch_sim.json").write_text(json.dumps(
        [{"gate": {"pass": True}}, {"gate": {"pass": False}}]))
    got = check_trajectories(tmp_path)
    assert [f.path for f in got] == ["BENCH_torch_sim.json"]


# ------------------------------------------------------------ compat
def test_compat_shims_resolve_here():
    x = torch.randn(6, 8, dtype=torch.bfloat16)
    w = torch.randn(2, 8, 8, dtype=torch.bfloat16)
    offs = torch.tensor([2, 6], dtype=torch.int32)
    out = compat.grouped_mm(x, w, offs)
    ref = torch.cat([x[:2].float() @ w[0].float(),
                     x[2:].float() @ w[1].float()])
    assert torch.allclose(out.float(), ref, rtol=2e-2, atol=2e-1)
    a = compat.sequence_nr()
    with torch.enable_grad():
        y = torch.zeros((), requires_grad=True) * 2
    assert compat.sequence_nr() > a
    assert a <= compat.node_sequence_nr(y.grad_fn) < compat.sequence_nr()
    T = compat.dtensor()
    assert T.DTensor.__name__ == "DTensor" and T.Shard(0).dim == 0


def test_compat_missing_spelling_raises_with_the_version(monkeypatch):
    monkeypatch.delattr(torch, "_grouped_mm")
    with pytest.raises(RuntimeError, match=re.escape(torch.__version__)):
        compat.grouped_mm(torch.zeros(1, 8), torch.zeros(1, 8, 8),
                          torch.ones(1, dtype=torch.int32))


# ------------------------------------ chip_smoke.py's "analysis" matching
def test_chip_smoke_analysis_matches_observed_syncs_to_the_rule():
    """The phase's matching on this checkout's lint: a sync on a flagged
    line passes, a sync in a hot function off every flagged line is missed
    (the planted fault), one outside the hot scope is only counted."""
    CS = chip_smoke()
    ctxs = load_modules([PKG], ROOT)
    rep = analyze_paths([PKG], root=ROOT)
    flagged = [(f.path, f.line, max(f.line, f.end_line))
               for f in rep.findings if f.rule == "TPR001"]
    scope = CS.hot_scope(ctxs)
    serve = next(f for f in rep.findings if f.rule == "TPR001"
                 and f.path.endswith("runtime/serve.py") and
                 ".tolist()" in f.message)
    hot_rec = ctxs[0].hotindex
    decode = next(r for r in hot_rec.hot
                  if r.qualname == "LM.decode_step")
    off = decode.node.body[-1].lineno              # a line it does not flag
    cold = next(c for c in ctxs if c.relpath.endswith("configs/base.py"))
    frame = {"source": "t", "function": "f", "raised_at": ""}
    frames = [dict(frame, path=serve.path, line=serve.line),
              dict(frame, path=decode and "src/repro_torch/models/"
                   "transformer.py", line=off),
              dict(frame, path=cold.relpath, line=10),
              dict(frame, path=None, line=None)]
    res = CS.match_syncs(frames, flagged, scope)
    assert res["hot"] == 2 and res["flagged"] == 1
    assert res["missed"] == {f"src/repro_torch/models/transformer.py:{off}":
                             1}
    assert res["outside_scope"] == {f"{cold.relpath}:10": 1}
    assert res["outside_package"] == 1
    # dropping the finding that covers the server's read misses it
    cut = [x for x in flagged if not (x[0] == serve.path and
                                      x[1] <= serve.line <= x[2])]
    assert f"{serve.path}:{serve.line}" in CS.match_syncs(
        frames[:1], cut, scope)["missed"]


def test_chip_smoke_package_frames_takes_the_innermost_package_def():
    CS = chip_smoke()
    import traceback

    class FakeRecord:
        message = "called a synchronizing CUDA operation"
        filename = os.path.join(CS.ROOT, "x.py")
        lineno = 3

    inner = traceback.FrameSummary(
        os.path.join(CS.PKG_ROOT, "sim", "batch.py"), 42, "_ticks")
    outer = traceback.FrameSummary(
        os.path.join(CS.PKG_ROOT, "sim", "engine.py"), 7, "run")
    lam = traceback.FrameSummary(
        os.path.join(CS.PKG_ROOT, "core", "dse.py"), 200, "<lambda>")
    torch_frame = traceback.FrameSummary("/x/torch/functional.py", 9, "f")
    sc = type("SC", (), {"records": [FakeRecord()],
                         "stacks": [[outer, inner, lam, torch_frame]]})()
    got = CS.package_frames(sc, "s")
    assert got == [{"source": "s", "path": "src/repro_torch/sim/batch.py",
                    "line": 42, "function": "_ticks", "raised_at": "x.py:3"}]


# ------------------------------------- what the rules found, fixed (TPR005)
def test_wrappers_without_a_backward_refuse_grad_on_the_card(monkeypatch):
    """``flash_decode`` and ``fused_tick_sim`` launched without
    ``refuse_grad`` (TPR005): on a (faked) card, an input that requires
    grad now raises and names the plain version, before any launch; a
    plain input still launches."""
    from repro_torch.kernels import flash_decode as PFD
    from repro_torch.kernels import tick_sim as PTS
    launched = []
    for mod, fn in ((PFD, "_launch"), (PTS, "_launch_kernel")):
        monkeypatch.setattr(mod, "on_card", lambda *t: True)
        monkeypatch.setattr(mod, fn, lambda *a, _n=fn, **k:
                            launched.append(_n))
    q = torch.randn(1, 1, 2, 8, requires_grad=True)
    cache = torch.randn(1, 4, 1, 8)
    pos, kpos = torch.tensor([3]), torch.arange(4)[None]
    with pytest.raises(RuntimeError, match="flash_decode_plain"):
        PFD.flash_decode(q, cache, cache, pos, kpos)
    arr = torch.rand(5, 2, requires_grad=True)
    with pytest.raises(RuntimeError, match="fused_tick_sim_plain"):
        PTS.fused_tick_sim(arr, {"base": torch.ones(1, 2)}, {}, {})
    assert launched == []
    with torch.no_grad():
        PFD.flash_decode(q, cache, cache, pos, kpos)
    PTS.fused_tick_sim(arr.detach(), {"base": torch.ones(1, 2)}, {}, {})
    assert launched == ["_launch", "_launch_kernel"]


def test_import_map_normalises_torch_numpy_and_relative_imports(tmp_path):
    from repro_torch.analysis.astutil import ImportMap, module_name
    (tmp_path / "pkg" / "sub").mkdir(parents=True)
    for init in ("pkg/__init__.py", "pkg/sub/__init__.py"):
        (tmp_path / init).write_text("")
    mod = tmp_path / "pkg" / "sub" / "m.py"
    mod.write_text("")
    assert module_name(mod) == "pkg.sub.m"
    tree = ast.parse("import torch\nimport torch.nn.functional as F\n"
                     "import numpy as np\nfrom . import layers as L\n"
                     "from ..core import dse\n")
    im = ImportMap(tree, "pkg.sub.m")
    assert im.normalize("F.softmax") == "torch.nn.functional.softmax"
    assert im.normalize("np.nonzero") == "numpy.nonzero"
    assert im.normalize("torch.cuda.synchronize") == "torch.cuda.synchronize"
    assert im.normalize("L.gqa_decode") == "pkg.sub.layers.gqa_decode"
    assert im.normalize("dse.grid_sweep") == "pkg.core.dse.grid_sweep"
