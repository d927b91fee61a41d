"""Shared AST machinery for the rule passes.

Three reusable layers, each the counterpart of the reference linter's
(``src/repro/analysis/astutil.py``), copied and then changed where PyTorch
code differs from JAX code:

* **Scope/import maps** — per-module parent links, import-alias
  normalization (``F`` -> ``torch.nn.functional``, ``np`` -> ``numpy``,
  ``L`` -> ``repro_torch.models.layers``; relative imports resolved against
  the module's own package), and a function index with lexical scope-chain
  lookup, so rules resolve ``Name`` call targets the way Python's own
  scoping does.
* **Hot-scope inference** (:class:`HotIndex`, the counterpart of the
  reference's ``TraceIndex``) — which functions of the analysed project run
  once per tick, per sweep block, per decode step or per train step: the
  declared hot entries (:data:`HOT_ENTRIES`; an entry may name the part of
  a function that runs per tick or block, and then only that part is hot:
  a ``for`` loop, a call, a nested function), the functions whose ``def``
  line carries ``# repro: hot``, and the transitive closure over the calls
  they make.  Where the reference closes over calls inside one module (a
  jitted function is traced with what it calls there, and an import
  boundary is a trace boundary only by accident), the port's hot scope is
  plain Python calling plain Python across modules: decode's host reads
  sit in ``models/layers.py`` and ``models/moe.py``, not in
  ``LM.decode_step``, and a tick's in ``sim/engine.py`` and
  ``sim/control.py``, not in ``BatchSimEngine._ticks``.  So the closure
  follows calls into every analysed module: names imported from another
  ``repro_torch`` module, attributes of an imported module
  (``L.attention(...)``), methods of ``self`` / ``cls`` in the class and its
  bases, methods of a parameter annotated with an analysed class
  (``lm: LM`` -> ``LM.loss_fn``), constructors (``Cls(...)`` ->
  ``Cls.__init__``) and local functions handed to a call as arguments
  (``checkpoint(body, x)``, ``eng._loop(trace, rates, control)``).  A call on
  an object whose class the source does not name is not followed; mark its
  target ``# repro: hot`` where it matters.
* **Tensor taint** (:func:`taint_function`) — which local names of a hot
  function (transitively) hold a tensor: parameters annotated
  ``torch.Tensor``; parameters that are not static by the reference's
  ``static_params`` rules (static: the config names of
  :data:`STATIC_PARAM_NAMES`, scalar / config annotations, and, for the
  port, any annotation that is not a tensor and any default that is a
  Python constant) *and* that the body uses as only a tensor is used (a
  tensor-only method or attribute, an argument of a ``torch.*`` call) —
  under ``jit`` every positional parameter is a tracer, in eager PyTorch
  most are Python values; the results of ``torch.*`` calls, of methods of
  tainted values, of calls into the project whose return annotation names
  a tensor, and of a namespace chosen by ``torch.is_tensor`` (the sweep's
  prefilter runs one formula over NumPy or torch).  A name proven a host
  value by ``isinstance(x, (int, np.ndarray, ...))`` is not tainted in
  that branch.  ``x is None`` checks, ``len()`` / ``isinstance()``,
  ``.shape`` / ``.ndim`` / ``.dtype`` / ``.device`` reads and
  ``.size()`` / ``.dim()`` / ``.numel()`` calls do not propagate taint (they
  are Python values on the host); nor do the results of the host syncs the
  walker flags (``.item()``, ``.tolist()``, ``.cpu()``, ``float()`` ...),
  which are host values once read.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)

# attribute reads that yield static Python values even on tensors
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_leaf",
                 "requires_grad", "layout", "names", "is_sparse", "itemsize",
                 "nbytes", "grad_fn", "is_meta", "is_quantized"}
# tensor methods whose results are static Python values (no sync)
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                   "data_ptr", "stride", "is_contiguous", "get_device",
                   "storage_offset", "is_floating_point", "is_complex",
                   "untyped_storage", "is_pinned", "type"}
# positional parameters treated as static configuration by name (the
# reference's list, plus the port's names for ticks, steps and counts)
STATIC_PARAM_NAMES = {"self", "cls", "cfg", "config", "opts", "options",
                      "plan", "spec", "mode", "kind", "backend", "name",
                      "t_i", "tick", "step", "steps", "device", "dtype",
                      "verbose", "label", "tag", "what"}
# annotations that mark a parameter as a static Python value
_STATIC_ANNOTATION_NAMES = {"int", "float", "bool", "str", "bytes",
                            "complex"}
_TENSOR_ANNOTATIONS = {"Tensor", "torch.Tensor"}
# host-side types in annotations (their values never hold a tensor)
_HOST_TYPES = {"ndarray", "None", "NoneType", "Path", "device", "dtype"}
# methods / attributes only a tensor has (not a NumPy array, a list, a
# dict or a string): a parameter used so is a tensor
_TENSOR_ONLY = {"to", "float", "double", "half", "bfloat16", "contiguous",
                "cpu", "cuda", "detach", "view", "unsqueeze", "numel", "dim",
                "masked_fill", "masked_fill_", "index_select", "scatter",
                "scatter_", "scatter_add", "scatter_add_", "index_add_",
                "index_put_", "expand", "expand_as", "permute", "new_zeros",
                "new_empty", "new_full", "new_ones", "softmax",
                "log_softmax", "clamp", "clamp_min", "clamp_max", "is_cuda",
                "device", "requires_grad", "requires_grad_", "data_ptr",
                "element_size", "bmm", "unflatten", "narrow", "type_as",
                "copy_", "add_", "mul_", "div_", "sub_", "zero_", "fill_",
                "amax", "amin", "logsumexp", "sigmoid", "view_as",
                "is_contiguous", "transpose", "mT", "grad", "grad_fn",
                "long", "int", "bool", "sum_to_size", "addcmul_",
                "lerp_", "pow_", "sqrt_", "neg", "abs_", "clone",
                "is_floating_point", "nan_to_num", "untyped_storage"}
# builtins whose results are static Python values
_STATIC_CALLS = {"len", "isinstance", "issubclass", "getattr", "hasattr",
                 "type", "id", "repr", "str", "format", "range", "max",
                 "min", "sorted", "tuple", "list", "dict", "set", "zip",
                 "enumerate", "callable", "print"}
# builtins that coerce their argument to a Python scalar: a host sync on
# a CUDA tensor (flagged by the walker; their results are host values)
_COERCIONS = {"bool", "int", "float", "complex"}
# torch namespaces / functions whose results are not tensors
_NON_TENSOR_TORCH = ("torch.device", "torch.dtype", "torch.Size",
                     "torch.is_tensor", "torch.is_grad_enabled",
                     "torch.is_floating_point", "torch.is_complex",
                     "torch.is_inference_mode_enabled",
                     "torch.get_default_dtype", "torch.finfo", "torch.iinfo",
                     "torch.no_grad", "torch.enable_grad",
                     "torch.inference_mode", "torch.set_grad_enabled",
                     "torch.Generator", "torch.cuda", "torch.distributed",
                     "torch.backends", "torch.profiler", "torch.utils",
                     "torch.compiler", "torch.testing", "torch.manual_seed",
                     "torch.version", "torch.are_deterministic_algorithms",
                     "torch.use_deterministic_algorithms",
                     "torch.get_num_threads", "torch.set_num_threads",
                     "torch.promote_types", "torch.result_type",
                     "torch.can_cast", "torch.set_default_dtype")
# host-sync methods of a tensor (flagged on any receiver that is not known
# to live on the host)
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize",
                "nonzero", "unique", "masked_select", "bincount",
                "argwhere", "unique_consecutive", "flatnonzero"}
# torch functions that wait for the card: the output's size depends on
# the data (the host must read it) or the call waits outright
SYNC_FUNCTIONS = {"torch.cuda.synchronize", "torch.nonzero", "torch.unique",
                  "torch.masked_select", "torch.bincount", "torch.argwhere",
                  "torch.unique_consecutive"}
# torch functions that copy their data argument onto a given device
_UPLOADS = {"torch.tensor", "torch.as_tensor", "torch.asarray"}
# calls whose results are boolean tensors (their use as an index is a
# boolean-mask index: a sync)
_BOOL_FUNCTIONS = {"isnan", "isinf", "isfinite", "isneginf", "isposinf",
                   "logical_and", "logical_or", "logical_not",
                   "logical_xor", "eq", "ne", "gt", "lt", "ge", "le",
                   "isclose", "isin", "signbit", "bool"}


def parse_module(source: str, filename: str = "<module>") -> ast.Module:
    return ast.parse(source, filename=filename)


def build_parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def module_name(path: Path) -> str:
    """Dotted module name of a source file: its stem, prefixed by every
    enclosing directory that holds an ``__init__.py`` (``src/repro_torch/
    sim/batch.py`` -> ``repro_torch.sim.batch``); a file outside a package
    is named by its stem."""
    p = path.resolve()
    parts = [] if p.stem == "__init__" else [p.stem]
    d = p.parent
    while (d / "__init__.py").exists():
        parts.insert(0, d.name)
        d = d.parent
    return ".".join(parts)


class ImportMap:
    """alias -> fully dotted origin (``F`` -> ``torch.nn.functional``,
    ``np`` -> ``numpy``, ``L`` -> ``repro_torch.models.layers``,
    ``tick_step`` -> ``repro_torch.sim.engine.tick_step``).  ``module`` (the
    importing module's dotted name) resolves relative imports."""

    def __init__(self, tree: ast.Module, module: str = "",
                 is_package: bool = False):
        self.alias: Dict[str, str] = {}
        pkg = module.split(".") if is_package else module.split(".")[:-1]
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.alias[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    up = pkg[:len(pkg) - (node.level - 1)] \
                        if node.level > 1 else pkg
                    base = ".".join([*up, *([base] if base else [])])
                if not base:
                    continue
                for a in node.names:
                    self.alias[a.asname or a.name] = f"{base}.{a.name}"

    def normalize(self, dotted: Optional[str]) -> Optional[str]:
        """Rewrite the leading alias of a dotted path to its origin."""
        if not dotted:
            return dotted
        head, _, rest = dotted.partition(".")
        origin = self.alias.get(head)
        if origin is None:
            return dotted
        return f"{origin}.{rest}" if rest else origin


@dataclass(eq=False)            # identity semantics: usable as dict key
class FunctionRecord:
    node: ast.AST                       # FunctionDef / AsyncFunctionDef
    qualname: str
    parent: Optional["FunctionRecord"]  # lexically enclosing function
    children: Dict[str, "FunctionRecord"] = field(default_factory=dict)
    cls: Optional[str] = None           # qualname of the class it is a
                                        # method of (directly), else None

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def lineno(self) -> int:
        return self.node.lineno

    def positional_params(self) -> List[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args]
        if a.vararg:
            names.append(a.vararg.arg)
        return names

    def kwonly_params(self) -> List[str]:
        a = self.node.args
        names = [p.arg for p in a.kwonlyargs]
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names

    def all_params(self) -> List[str]:
        return self.positional_params() + self.kwonly_params()


class FunctionIndex:
    """Every function def in a module, with lexical scope-chain lookup, and
    every class with its methods and the names of its bases."""

    def __init__(self, tree: ast.Module):
        self.records: List[FunctionRecord] = []
        self.module_scope: Dict[str, FunctionRecord] = {}
        self.by_qualname: Dict[str, FunctionRecord] = {}  # repro: noqa[TPR003] one entry per def of the module, built once per parse
        self.classes: Dict[str, ast.ClassDef] = {}  # repro: noqa[TPR003] qualname -> node, one entry per class of the module
        self._by_node: Dict[ast.AST, FunctionRecord] = {}
        self._collect(tree, parent=None, prefix="", cls=None)

    def _collect(self, node: ast.AST, parent: Optional[FunctionRecord],
                 prefix: str, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, FuncDef):
                qual = f"{prefix}{child.name}"
                rec = FunctionRecord(child, qual, parent, cls=cls)
                self.records.append(rec)
                self.by_qualname.setdefault(qual, rec)
                self._by_node[child] = rec
                if parent is None and cls is None:
                    self.module_scope[child.name] = rec
                elif parent is not None:
                    parent.children[child.name] = rec
                self._collect(child, rec, prefix=f"{qual}.", cls=None)
            elif isinstance(child, ast.ClassDef):
                qual = f"{prefix}{child.name}"
                self.classes.setdefault(qual, child)
                self._collect(child, parent, prefix=f"{qual}.", cls=qual)
            else:
                self._collect(child, parent, prefix=prefix, cls=cls)

    def record_for(self, node: ast.AST) -> Optional[FunctionRecord]:
        return self._by_node.get(node)

    def lookup(self, scope: Optional[FunctionRecord],
               name: str) -> Optional[FunctionRecord]:
        """Resolve ``name`` as Python scoping would: the scope's own
        nested defs, then enclosing functions' defs, then module defs."""
        cur = scope
        while cur is not None:
            if name in cur.children:
                return cur.children[name]
            cur = cur.parent
        return self.module_scope.get(name)

    def enclosing_class(self, rec: Optional[FunctionRecord]
                        ) -> Optional[str]:
        """The class whose method ``rec`` is, or encloses ``rec``."""
        while rec is not None:
            if rec.cls is not None:
                return rec.cls
            rec = rec.parent
        return None


def enclosing_function(parents: Dict[ast.AST, ast.AST],
                       index: FunctionIndex,
                       node: ast.AST) -> Optional[FunctionRecord]:
    cur = parents.get(node)
    while cur is not None:
        rec = index.record_for(cur)
        if rec is not None:
            return rec
        cur = parents.get(cur)
    return None


# ---------------------------------------------------------------------------
# Hot scope
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HotEntry:
    """A declared hot entry: the function ``qualname`` of a module whose
    path ends with ``path``.  With ``part``, only the part of it that runs
    per tick or block is hot: the ``for`` loop whose target is the name
    ``part``, else the call of ``part`` (``self._ticks(...)``), else the
    nested function ``part`` (a closure the loop calls back)."""
    path: str
    qualname: str
    part: Optional[str] = None


# what runs once per tick, per sweep block, per decode step, per train step
# (an engine's set-up and the summaries after its loop are not)
HOT_ENTRIES: Tuple[HotEntry, ...] = (
    HotEntry("sim/batch.py", "BatchSimEngine._loop", part="_ticks"),
    HotEntry("sim/batch.py", "BatchSimEngine._ticks"),
    HotEntry("sim/engine.py", "SimEngine.run", part="control"),
    HotEntry("core/dse.py", "_eval_flat_points_t"),
    HotEntry("core/dse.py", "grid_sweep", part="o0"),
    HotEntry("models/transformer.py", "LM.decode_step"),
    HotEntry("runtime/serve.py", "ServeEngine.step"),
    HotEntry("runtime/train.py", "step_grads"),
    HotEntry("runtime/train.py", "make_train_step.train_step"),
)

HOT_MARKER = "repro: hot"


@dataclass
class HotInfo:
    kind: str                     # "entry" | "marker" | "called"
    via: str                      # human-readable provenance
    region: Optional[ast.AST] = None   # the hot part of a part entry


@dataclass
class ModuleView:
    """What :class:`HotIndex` reads of one parsed module (the engine's
    ``ModuleContext`` carries one)."""
    relpath: str
    module: str
    tree: ast.Module
    lines: Sequence[str]
    imports: ImportMap
    funcindex: FunctionIndex
    path: Optional[Path] = None         # the source file


def view_of_file(path: Path, relpath: str = "") -> Optional[ModuleView]:
    """A :class:`ModuleView` of one source file (None if unreadable)."""
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    module = module_name(path)
    return ModuleView(relpath or path.as_posix(), module, tree,
                      source.splitlines(),
                      ImportMap(tree, module,
                                is_package=path.stem == "__init__"),
                      FunctionIndex(tree), path)


def _part_of(rec: FunctionRecord, part: str
             ) -> Tuple[Optional[FunctionRecord], Optional[ast.AST]]:
    """``(record, region)`` of the part ``part`` of ``rec`` (see
    :class:`HotEntry`): a loop or a call is a region of ``rec``, a nested
    function is a record of its own, hot as a whole."""
    for n in ast.walk(rec.node):
        if isinstance(n, ast.For) and isinstance(n.target, ast.Name) \
                and n.target.id == part:
            return rec, n
    for n in ast.walk(rec.node):
        if isinstance(n, ast.Call) and (
                isinstance(n.func, ast.Name) and n.func.id == part or
                isinstance(n.func, ast.Attribute) and n.func.attr == part):
            return rec, n
    child = rec.children.get(part)
    return (child, None) if child is not None else (None, None)


class HotIndex:
    """Which functions of the analysed project are hot, and how."""

    def __init__(self, views: Sequence[ModuleView],
                 entries: Sequence[HotEntry] = HOT_ENTRIES):
        self.views = list(views)
        # modules read for resolution only, one entry per module a run names
        self._extra: Dict[str, Optional[ModuleView]] = {}
        self.by_module: Dict[str, ModuleView] = {v.module: v
                                                 for v in self.views}
        self.hot: Dict[FunctionRecord, HotInfo] = {}  # repro: noqa[TPR003] result map bounded by the project's function count, built once per run
        self.view_of: Dict[FunctionRecord, ModuleView] = {}
        for v in self.views:
            for rec in v.funcindex.records:
                self.view_of[rec] = v
        self._find_entries(entries)
        self._find_markers()
        self._close_over_calls()

    # ---------------------------------------------------------- queries
    def info(self, rec: FunctionRecord) -> Optional[HotInfo]:
        return self.hot.get(rec)

    def functions(self, view: ModuleView
                  ) -> List[Tuple[FunctionRecord, HotInfo]]:
        return [(r, i) for r, i in self.hot.items()
                if self.view_of[r] is view]

    # ----------------------------------------------------- entry finding
    def _find_entries(self, entries: Sequence[HotEntry]) -> None:
        for e in entries:
            found = False
            for v in self.views:
                if not v.relpath.endswith(e.path):
                    continue
                rec = v.funcindex.by_qualname.get(e.qualname)
                if rec is None:
                    continue
                region = None
                if e.part is not None:
                    rec, region = _part_of(rec, e.part)
                    if rec is None:
                        continue
                found = True
                where = f"{e.qualname}" + (f" part `{e.part}`"
                                           if e.part else "")
                self.hot.setdefault(rec, HotInfo(
                    "entry", f"hot entry {where}", region))

    def _find_markers(self) -> None:
        """Opt-in ``# repro: hot`` comment on a def line."""
        for v in self.views:
            for rec in v.funcindex.records:
                line = ""
                if 0 < rec.lineno <= len(v.lines):
                    line = v.lines[rec.lineno - 1]
                if "#" in line and HOT_MARKER in line.split("#", 1)[1]:
                    self.hot.setdefault(rec, HotInfo(
                        "marker", "# repro: hot"))

    # ------------------------------------------------------ resolution
    def _module(self, name: str) -> Optional[ModuleView]:
        """The view of module ``name``: an analysed one, else the source
        file of the same package, read for resolution only (a partial run
        resolves calls as a whole one does; its functions give no
        findings)."""
        v = self.by_module.get(name)
        if v is not None or name in self._extra:
            return v if v is not None else self._extra[name]
        found = None
        for w in self.views:
            head = w.module.split(".")[0]
            if w.path is None or not name.startswith(head + ".") and \
                    name != head:
                continue
            base = w.path.resolve().parents[len(w.module.split(".")) - 1]
            if w.path.stem == "__init__":
                base = base.parent
            rel = Path(*name.split("."))
            for cand in (base / rel.with_suffix(".py"),
                         base / rel / "__init__.py"):
                if cand.is_file():
                    found = view_of_file(cand)
                    break
            break
        self._extra[name] = found
        if found is not None:
            for rec in found.funcindex.records:
                self.view_of[rec] = found
        return found

    def _module_attr(self, dotted: Optional[str]
                     ) -> Optional[FunctionRecord]:
        """``pkg.mod.f`` / ``pkg.mod.Cls`` / ``pkg.mod.Cls.m`` -> a record
        of an analysed module (a class names its ``__init__``)."""
        if not dotted or "." not in dotted:
            return None
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            v = self._module(".".join(parts[:cut]))
            if v is None:
                continue
            rest = ".".join(parts[cut:])
            rec = v.funcindex.by_qualname.get(rest)
            if rec is not None and rec.parent is None:
                return rec
            if rest in v.funcindex.classes:
                return self._method(v, rest, "__init__")
            return None
        return None

    def _class_view(self, v: ModuleView, name: str
                    ) -> Optional[Tuple[ModuleView, str]]:
        """The view and qualname of the class ``name`` seen from ``v``."""
        if name in v.funcindex.classes:
            return v, name
        origin = v.imports.normalize(name)
        if origin and origin != name and "." in origin:
            mod, _, cname = origin.rpartition(".")
            w = self._module(mod)
            if w is not None and cname in w.funcindex.classes:
                return w, cname
        return None

    def _method(self, v: ModuleView, cls: str, meth: str,
                depth: int = 0) -> Optional[FunctionRecord]:
        """``cls.meth`` in ``v``, else in the bases the source names."""
        rec = v.funcindex.by_qualname.get(f"{cls}.{meth}")
        if rec is not None or depth > 8:
            return rec
        node = v.funcindex.classes.get(cls)
        for base in (node.bases if node is not None else ()):
            name = dotted_name(base)
            found = self._class_view(v, name) if name else None
            if found is not None:
                rec = self._method(found[0], found[1], meth, depth + 1)
                if rec is not None:
                    return rec
        return None

    def _annotated_class(self, v: ModuleView, scope: FunctionRecord,
                         name: str) -> Optional[Tuple[ModuleView, str]]:
        a = scope.node.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.arg == name and p.annotation is not None:
                ann = p.annotation
                if isinstance(ann, ast.Subscript) and dotted_name(
                        ann.value) in ("Optional", "typing.Optional"):
                    ann = ann.slice
                if isinstance(ann, ast.Constant) and \
                        isinstance(ann.value, str):
                    ann_name = ann.value
                else:
                    ann_name = dotted_name(ann)
                return self._class_view(v, ann_name) if ann_name else None
        return None

    def resolve_target(self, v: ModuleView,
                       scope: Optional[FunctionRecord], call: ast.Call
                       ) -> Optional[FunctionRecord]:
        """The analysed function a call runs, where the source names it."""
        func = call.func
        if isinstance(func, ast.Name):
            rec = v.funcindex.lookup(scope, func.id)
            if rec is None and func.id in v.funcindex.classes:
                rec = self._method(v, func.id, "__init__")
            if rec is None:
                rec = self._module_attr(v.imports.normalize(func.id))
            return rec
        if not isinstance(func, ast.Attribute):
            return None
        base = func.value
        if isinstance(base, ast.Name) and base.id in ("self", "cls") \
                and scope is not None:
            cls = v.funcindex.enclosing_class(scope)
            return self._method(v, cls, func.attr) if cls else None
        rec = self._module_attr(v.imports.normalize(dotted_name(func)))
        if rec is not None:
            return rec
        found = self._type_of(v, scope, base)
        return (self._method(found[0], found[1], func.attr)
                if found is not None else None)

    def _type_of(self, v: ModuleView, scope: Optional[FunctionRecord],
                 e: ast.AST, depth: int = 0
                 ) -> Optional[Tuple[ModuleView, str]]:
        """The analysed class of an expression, where the source says it:
        a parameter's annotation, a local bound to a constructor call or
        to such an expression, ``self.x`` bound so in a method of the
        class (or annotated in its body)."""
        if depth > 4 or scope is None:
            return None
        if isinstance(e, ast.Call):
            name = dotted_name(e.func)
            return self._class_view(v, name) if name else None
        if isinstance(e, ast.Name):
            if e.id in scope.all_params():
                return self._annotated_class(v, scope, e.id)
            rhss = [n.value for n in ast.walk(scope.node)
                    if isinstance(n, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == e.id
                        for t in n.targets)]
            if len(rhss) == 1:
                return self._type_of(v, scope, rhss[0], depth + 1)
            return None
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name):
            # ``self.x`` (or a state object's ``lp.x``) bound to a
            # constructor or a typed parameter in a method of the class
            cls = v.funcindex.enclosing_class(scope)
            node = v.funcindex.classes.get(cls) if cls else None
            if node is None:
                return None
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and \
                        isinstance(stmt.target, ast.Name) and \
                        stmt.target.id == e.attr:
                    name = dotted_name(stmt.annotation)
                    return self._class_view(v, name) if name else None
            for rec in v.funcindex.records:
                if rec.cls != cls:
                    continue
                for n in ast.walk(rec.node):
                    if isinstance(n, (ast.Assign, ast.AnnAssign)):
                        tgts = (n.targets if isinstance(n, ast.Assign)
                                else [n.target])
                        if any(isinstance(t, ast.Attribute)
                               and isinstance(t.value, ast.Name)
                               and t.value.id == e.value.id
                               and t.attr == e.attr
                               for t in tgts) and n.value is not None:
                            found = self._type_of(v, rec, n.value,
                                                  depth + 1)
                            if found is not None:
                                return found
        return None

    def resolve_call(self, v: ModuleView, scope: Optional[FunctionRecord],
                     call: ast.Call) -> List[FunctionRecord]:
        """The analysed functions a call may run (its target, and the
        local functions handed to it as arguments)."""
        out: List[FunctionRecord] = []
        rec = self.resolve_target(v, scope, call)
        if rec is not None:
            out.append(rec)
        for arg in list(call.args) + [k.value for k in call.keywords]:
            if isinstance(arg, ast.Name):
                rec = v.funcindex.lookup(scope, arg.id)
                if rec is not None:
                    out.append(rec)
        return out

    def resolver(self, v: ModuleView, scope: Optional[FunctionRecord]):
        """``call -> record`` inside ``scope`` of ``v`` (for the taint)."""
        return lambda call: self.resolve_target(v, scope, call)

    def resolve_ref(self, v: ModuleView, scope: Optional[FunctionRecord],
                    node: ast.AST) -> Optional[FunctionRecord]:
        """The analysed function a bare reference names (``decode =
        L.gqa_decode``, ``gmm=grouped_matmul_plain``, ``self._step``): a
        function named and not called is handed on to be called."""
        if isinstance(node, ast.Name):
            rec = v.funcindex.lookup(scope, node.id)
            return rec or self._module_attr(v.imports.normalize(node.id))
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name):
            base = node.value.id
            if base in ("self", "cls") and scope is not None:
                cls = v.funcindex.enclosing_class(scope)
                return self._method(v, cls, node.attr) if cls else None
            if base in v.imports.alias:
                return self._module_attr(v.imports.normalize(
                    dotted_name(node)))
        return None

    def _close_over_calls(self) -> None:
        """Transitively mark what hot functions call or hand on."""
        work = list(self.hot.items())
        while work:
            rec, info = work.pop()
            v = self.view_of[rec]
            root = info.region if info.region is not None else rec.node
            called = {id(n.func) for n in ast.walk(root)
                      if isinstance(n, ast.Call)}
            for node in ast.walk(root):
                if isinstance(node, (ast.Name, ast.Attribute)) and \
                        isinstance(node.ctx, ast.Load) and \
                        id(node) not in called:
                    ref = self.resolve_ref(v, rec, node)
                    targets = [ref] if ref is not None and \
                        ref.node is not rec.node else []
                elif isinstance(node, ast.Call):
                    targets = self.resolve_call(v, rec, node)
                else:
                    continue
                for callee in targets:
                    if callee in self.hot or callee is rec:
                        continue
                    sub = HotInfo("called",
                                  f"called from {rec.qualname} "
                                  f"({self.view_of[rec].relpath}:"
                                  f"{node.lineno})")
                    self.hot[callee] = sub
                    work.append((callee, sub))


# ---------------------------------------------------------------------------
# Tensor taint
# ---------------------------------------------------------------------------


@dataclass
class TaintFlag:
    node: ast.AST
    reason: str                 # "branch"|"coerce"|"copy"|"sync"|"assert"
    detail: str


def _annotation_is_tensor(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value in _TENSOR_ANNOTATIONS or \
            ann.value.endswith(".Tensor")
    if isinstance(ann, ast.Subscript):          # Optional[Tensor] etc.
        name = dotted_name(ann.value)
        if name and name.rsplit(".", 1)[-1] in ("Optional", "Union"):
            inner = ann.slice
            elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
            return any(_annotation_is_tensor(e) for e in elts)
        return False
    name = dotted_name(ann)
    return bool(name) and name.rsplit(".", 1)[-1] == "Tensor"


def _returns_tensors(ann: ast.AST) -> bool:
    """A return annotation that may hold tensors: a container or tuple of
    them, a mapping, ``Any``, a class of the project (a dataclass of
    tensors).  Scalars, strings and ``None`` do not."""
    if isinstance(ann, ast.Constant):
        if ann.value is None:
            return False
        if isinstance(ann.value, str):
            return ann.value.rsplit(".", 1)[-1] not in \
                _STATIC_ANNOTATION_NAMES
    name = dotted_name(ann.value if isinstance(ann, ast.Subscript) else ann)
    last = (name or "").rsplit(".", 1)[-1]
    if last in _STATIC_ANNOTATION_NAMES or last in _HOST_TYPES or \
            (name or "").split(".")[0] in ("np", "numpy"):
        return False
    if isinstance(ann, ast.Subscript) and last in ("Dict", "dict",
                                                   "Mapping"):
        inner = ann.slice
        elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
        return _annotation_is_tensor(elts[-1]) or \
            _returns_tensors(elts[-1])
    if isinstance(ann, ast.Subscript) and last in ("Optional", "Union",
                                                   "Tuple", "tuple", "List",
                                                   "list", "Sequence"):
        inner = ann.slice
        elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
        return any(_annotation_is_tensor(x) or _returns_tensors(x)
                   for x in elts if not isinstance(x, ast.Constant)
                   or x.value not in (None, Ellipsis))
    return True


def _annotation_is_static(ann: Optional[ast.AST]) -> bool:
    """Any annotation that is not a tensor: int/float/bool/str/..., a
    *Config/*Options/... type, a container, a class of the project."""
    if ann is None:
        return False
    return not _annotation_is_tensor(ann)


def _default_is_static(default: Optional[ast.AST]) -> bool:
    if default is None:
        return False
    if isinstance(default, ast.Constant):
        return default.value is not None
    if isinstance(default, (ast.Tuple, ast.List)):
        return all(isinstance(e, ast.Constant) for e in default.elts)
    if isinstance(default, ast.UnaryOp):
        return isinstance(default.operand, ast.Constant)
    return False


def static_params(rec: FunctionRecord) -> Set[str]:
    """Parameters NOT treated as tensors: config-by-name, annotated with
    anything but a tensor, or defaulting to a Python constant."""
    out = set(STATIC_PARAM_NAMES)
    a = rec.node.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    for p, d in zip(pos, defaults):
        if _annotation_is_static(p.annotation) or _default_is_static(d):
            out.add(p.arg)
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if _annotation_is_static(p.annotation) or _default_is_static(d):
            out.add(p.arg)
    return out


def _tensor_evidence(rec: FunctionRecord, imports: ImportMap) -> Set[str]:
    """Names the body uses as only a tensor is used: a tensor-only method
    or attribute read on them, or handed to a ``torch.*`` call."""
    out: Set[str] = set()
    for node in ast.walk(rec.node):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.attr in _TENSOR_ONLY:
            out.add(node.value.id)
        elif isinstance(node, ast.Call):
            callee = imports.normalize(dotted_name(node.func)) or ""
            if callee.startswith("torch.") and not any(
                    callee == r or callee.startswith(r + ".")
                    for r in _NON_TENSOR_TORCH):
                out.update(a.id for a in node.args
                           if isinstance(a, ast.Name))
    return out


def tensor_params(rec: FunctionRecord, imports: Optional[ImportMap] = None
                  ) -> Set[str]:
    """The parameters that hold tensors: annotated ``torch.Tensor``; or not
    static by the reference's rules *and* used as a tensor in the body.
    An unannotated parameter with no such use is most often a Python value
    or a NumPy array in this code base (tick indices, config dicts, host
    histories), whose branches cost nothing."""
    statics = static_params(rec)
    a = rec.node.args
    annotated = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                 if _annotation_is_tensor(p.annotation)}
    evidence = _tensor_evidence(rec, imports or ImportMap(ast.Module(
        body=[], type_ignores=[])))
    return {p for p in rec.all_params()
            if p in annotated or (p not in statics and p in evidence)}


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device(
    "cpu"))``."""
    def is_cpu(e):
        if isinstance(e, ast.Constant) and isinstance(e.value, str):
            return e.value.split(":")[0] == "cpu"
        if isinstance(e, ast.Call) and dotted_name(e.func) in (
                "torch.device", "device") and e.args:
            return is_cpu(e.args[0])
        return False
    return (isinstance(call.func, ast.Attribute) and call.func.attr == "to"
            and (any(is_cpu(a) for a in call.args)
                 or any(k.arg == "device" and is_cpu(k.value)
                        for k in call.keywords)))


class _TaintWalker:
    def __init__(self, rec: FunctionRecord, imports: ImportMap,
                 resolve=None):
        self.rec = rec
        self.imports = imports
        self.tainted: Set[str] = tensor_params(rec, imports)
        self.resolve = resolve
        self.host: Set[str] = set()       # names known to hold host values
        self.dual: Set[str] = set()       # names bound by ``A if
                                          # torch.is_tensor(x) else B``:
                                          # a namespace whose calls give
                                          # tensors on one branch
        self.containers: Set[str] = set()  # names bound to a list / tuple /
                                           # dict display (their truth is
                                           # their length)
        self.masks: Set[str] = set()      # names holding boolean tensors
        self.flags: List[TaintFlag] = []
        self._seen: Set[int] = set()

    # -------------------------------------------------- expression taint
    def callee(self, call: ast.Call) -> Optional[str]:
        return self.imports.normalize(dotted_name(call.func))

    def _torch_tensor_call(self, callee: Optional[str]) -> bool:
        if not callee or not (callee == "torch"
                              or callee.startswith("torch.")):
            return False
        return not any(callee == r or callee.startswith(r + ".")
                       for r in _NON_TENSOR_TORCH)

    def is_host(self, e: ast.AST) -> bool:
        """Known to live on the host: NumPy results, a sync's result, a
        host-known name, a literal."""
        if isinstance(e, ast.Constant):
            return True
        if isinstance(e, ast.Name):
            return e.id in self.host
        if isinstance(e, (ast.Attribute, ast.Subscript)):
            return self.is_host(e.value)
        if isinstance(e, ast.Call):
            callee = self.callee(e)
            if callee and (callee == "numpy" or callee.startswith("numpy.")):
                return True
            if callee in _COERCIONS or _to_cpu(e) or \
                    callee == "torch.from_numpy":
                return True
            if isinstance(e.func, ast.Attribute):
                if e.func.attr in ("item", "tolist", "cpu", "numpy"):
                    return True
                return self.is_host(e.func.value)
        return False

    def expr_tainted(self, e: Optional[ast.AST]) -> bool:
        if e is None or isinstance(e, (ast.Constant, ast.Lambda)):
            return False
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute):
            if e.attr in _STATIC_ATTRS:
                return False
            return self.expr_tainted(e.value)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return False          # identity / membership: Python bools
            return (self.expr_tainted(e.left)
                    or any(self.expr_tainted(c) for c in e.comparators))
        if isinstance(e, ast.Call):
            callee = self.callee(e)
            if callee in _STATIC_CALLS or callee in _COERCIONS:
                return False
            if callee and (callee == "numpy" or callee.startswith("numpy.")):
                return False          # a host value (a tensor cannot get
                                      # there without a flagged copy)
            if self._torch_tensor_call(callee):
                return True
            if callee and callee.startswith("torch."):
                return False          # torch.device, torch.is_tensor, ...
            if isinstance(e.func, ast.Attribute):
                if e.func.attr in _STATIC_METHODS or \
                        e.func.attr in ("item", "tolist", "cpu", "numpy") \
                        or _to_cpu(e):
                    return False
                if self.expr_tainted(e.func.value):
                    return True
                if isinstance(e.func.value, ast.Name) and \
                        e.func.value.id in self.dual:
                    return True
            target = self.resolve(e) if self.resolve is not None else None
            if target is not None and target.node.returns is not None:
                return _annotation_is_tensor(target.node.returns) or (
                    _returns_tensors(target.node.returns)
                    and self._args_tainted(e))
            return self._args_tainted(e)
        if isinstance(e, ast.IfExp):
            return self.expr_tainted(e.body) or self.expr_tainted(e.orelse)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            for gen in e.generators:
                self._bind_loop_target(gen.target, gen.iter)
            parts = ([e.key, e.value] if isinstance(e, ast.DictComp)
                     else [e.elt])
            for p in parts:
                self._scan_expr_for_flags(p)
            return self.expr_tainted(parts[-1])   # a dict by its values
        if isinstance(e, ast.Dict):
            return any(self.expr_tainted(v) for v in e.values)
        if isinstance(e, ast.JoinedStr):
            return False
        return any(self.expr_tainted(c) for c in ast.iter_child_nodes(e))

    def _args_tainted(self, e: ast.Call) -> bool:
        return (any(self.expr_tainted(a) for a in e.args)
                or any(self.expr_tainted(k.value) for k in e.keywords))

    def is_mask(self, e: ast.AST) -> bool:
        """A boolean tensor: a comparison, ``~``, ``&`` / ``|`` of masks,
        ``torch.isnan`` & co. or a name holding one, on tainted data."""
        if isinstance(e, ast.Name):
            return e.id in self.masks
        if isinstance(e, ast.Compare):
            return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                           ast.NotIn)) for op in e.ops) \
                and self.expr_tainted(e)
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
            return self.is_mask(e.operand) or self.expr_tainted(e.operand)
        if isinstance(e, ast.BinOp) and isinstance(
                e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(e.left) or self.is_mask(e.right)
        if isinstance(e, ast.Call):
            callee = self.callee(e) or ""
            last = callee.rsplit(".", 1)[-1]
            if callee.startswith("torch.") and last in _BOOL_FUNCTIONS:
                return True
            if isinstance(e.func, ast.Attribute) and \
                    e.func.attr in _BOOL_FUNCTIONS and \
                    self.expr_tainted(e.func.value):
                return True
        return False

    # ------------------------------------------------------- assignment
    def _taint_target(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
            self.host.discard(target.id)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._taint_target(el)
        elif isinstance(target, ast.Subscript) and \
                isinstance(target.value, ast.Name) and \
                target.value.id != "self":
            # storing a tensor into x[...] makes x a tensor (or a
            # container of them); storing into an attribute of an object
            # does not make the object one
            self.tainted.add(target.value.id)

    def _assign(self, target: ast.AST, value: ast.AST) -> None:
        """Taint only grows (as in the reference): a name that held a
        tensor on one path may hold it on the next statement's."""
        if self.expr_tainted(value):
            self._taint_target(target)
            if isinstance(target, ast.Name) and self.is_mask(value):
                self.masks.add(target.id)
        if isinstance(target, ast.Name) and isinstance(
                value, (ast.List, ast.Tuple, ast.Dict, ast.Set, ast.ListComp,
                        ast.DictComp, ast.SetComp)):
            self.containers.add(target.id)
        if isinstance(target, ast.Name) and isinstance(value, ast.IfExp) \
                and any(isinstance(c, ast.Call) and self.callee(c) ==
                        "torch.is_tensor" for c in ast.walk(value.test)):
            self.dual.add(target.id)
        if isinstance(target, ast.Name) and target.id not in self.tainted:
            if self.is_host(value):
                self.host.add(target.id)
            else:
                self.host.discard(target.id)

    def _bind_loop_target(self, target: ast.AST, it: ast.AST) -> None:
        """zip/enumerate-aware element-wise loop-target tainting."""
        callee = self.imports.normalize(dotted_name(it.func)) \
            if isinstance(it, ast.Call) else None
        if callee == "zip" and isinstance(target, (ast.Tuple, ast.List)) \
                and isinstance(it, ast.Call) \
                and len(it.args) == len(target.elts):
            for el, arg in zip(target.elts, it.args):
                if self.expr_tainted(arg):
                    self._taint_target(el)
            return
        if callee == "enumerate" and isinstance(target,
                                                (ast.Tuple, ast.List)) \
                and isinstance(it, ast.Call) and it.args \
                and len(target.elts) == 2:
            if self.expr_tainted(it.args[0]):
                self._taint_target(target.elts[1])
            return
        if self.expr_tainted(it):
            self._taint_target(target)

    # ---------------------------------------------------------- flagging
    def _flag(self, node: ast.AST, reason: str, detail: str) -> None:
        if id(node) in self._seen:
            return
        self._seen.add(id(node))
        self.flags.append(TaintFlag(node, reason, detail))

    def _flag_call(self, call: ast.Call) -> None:
        callee = self.callee(call)
        if callee in _COERCIONS and call.args \
                and self.expr_tainted(call.args[0]):
            self._flag(call, "coerce",
                       f"{callee}() of a tensor reads it back to the host")
            return
        if callee in SYNC_FUNCTIONS:
            self._flag(call, "sync", f"`{callee}` waits for the card")
            return
        if callee in ("torch.where",) and len(call.args) == 1 \
                and not call.keywords:
            self._flag(call, "sync",
                       "one-argument `torch.where` is `nonzero`: its size "
                       "is read back to the host")
            return
        if callee in _UPLOADS and self._uploads(call):
            self._flag(call, "upload",
                       f"`{callee}` of host data onto the card copies from "
                       "pageable memory: the host waits for the copy")
            return
        if callee in ("torch.repeat_interleave",) and \
                self._data_dependent_repeats(call, 1):
            self._flag(call, "sync",
                       "`repeat_interleave` with tensor repeats and no "
                       "`output_size` reads the total back to the host")
            return
        if not isinstance(call.func, ast.Attribute):
            return
        root = call.func
        while isinstance(root, ast.Attribute):
            root = root.value
        if isinstance(root, ast.Name) and root.id in self.imports.alias:
            return                     # a module's function, not a method
        attr, recv = call.func.attr, call.func.value
        if _to_cpu(call):
            self._flag(call, "copy",
                       "`.to(\"cpu\")` copies a tensor to the host")
        elif attr in ("to", "cuda") and self.is_host(recv) and \
                (call.args or call.keywords or attr == "cuda") and \
                not any(k.arg == "non_blocking" for k in call.keywords) \
                and not (attr == "to" and call.args and
                         dotted_name(call.args[0]) and
                         "dtype" in (dotted_name(call.args[0]) or "")):
            self._flag(call, "upload",
                       f"`.{attr}()` of a host tensor onto the card copies "
                       "from pageable memory: the host waits for the copy")
        elif attr == "repeat_interleave" and \
                self._data_dependent_repeats(call, 0) and \
                not self.is_host(recv):
            self._flag(call, "sync",
                       "`repeat_interleave` with tensor repeats and no "
                       "`output_size` reads the total back to the host")
        elif attr in SYNC_METHODS and not call.args[1:] and \
                not self.is_host(recv) and \
                not (attr == "numpy" and self._under_copy(recv)):
            what = {"item": "reads a tensor back to the host",
                    "tolist": "reads a tensor back to the host",
                    "cpu": "copies a tensor to the host",
                    "numpy": "reads a tensor as a host array",
                    "synchronize": "waits for the card"}.get(
                attr, "has a data-dependent output size: the host "
                      "reads it")
            self._flag(call, "copy" if attr in ("cpu", "numpy", "tolist",
                                                "item") else "sync",
                       f"`.{attr}()` {what}")

    def _uploads(self, call: ast.Call) -> bool:
        """``torch.tensor`` / ``as_tensor`` of host data with a device
        that is not the CPU."""
        dev = next((k.value for k in call.keywords if k.arg == "device"),
                   call.args[2] if len(call.args) > 2 else None)
        if dev is None or (isinstance(dev, ast.Constant) and
                           str(dev.value).split(":")[0] == "cpu"):
            return False
        return bool(call.args) and not self.expr_tainted(call.args[0])

    def _under_copy(self, e: ast.AST) -> bool:
        """``x.cpu().numpy()`` / ``x.detach().cpu().numpy()``: the copy is
        flagged once, at ``.cpu()``."""
        while isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute):
            if e.func.attr == "cpu" or _to_cpu(e):
                return True
            e = e.func.value
        return False

    def _data_dependent_repeats(self, call: ast.Call, pos: int) -> bool:
        if any(k.arg == "output_size" for k in call.keywords):
            return False
        rep = call.args[pos] if len(call.args) > pos else next(
            (k.value for k in call.keywords if k.arg == "repeats"), None)
        return rep is not None and self.expr_tainted(rep)

    def _scan_expr_for_flags(self, e: Optional[ast.AST]) -> None:
        if e is None:
            return
        for node in ast.walk(e):
            if isinstance(node, ast.Call):
                self._flag_call(node)
            elif isinstance(node, ast.IfExp) and \
                    self.expr_tainted(node.test):
                self._flag(node.test, "branch",
                           "conditional expression on a tensor reads it "
                           "back to the host (use torch.where)")
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load) and \
                    self.is_mask(node.slice) and \
                    not self.is_host(node.value):
                self._flag(node, "sync",
                           "boolean-mask indexing has a data-dependent "
                           "size: the host reads it")
            elif isinstance(node, ast.Lambda):
                continue

    def _narrowed(self, test: ast.AST) -> Set[str]:
        """Names ``isinstance(x, (int, float, np.ndarray, ...))`` proves
        are host values inside the branch (Python scalars, NumPy)."""
        self._was_tainted: Set[str] = set()
        if isinstance(test, ast.Call) and dotted_name(test.func) == \
                "isinstance" and len(test.args) == 2 and \
                isinstance(test.args[0], ast.Name):
            kinds = test.args[1]
            elts = kinds.elts if isinstance(kinds, ast.Tuple) else [kinds]
            host = [(self.imports.normalize(dotted_name(k)) or "")
                    for k in elts]
            if elts and all(h in _STATIC_ANNOTATION_NAMES
                            or h.startswith("numpy.") for h in host):
                name = test.args[0].id
                self._was_tainted = {name} & self.tainted
                return {name}
        return set()

    def _test(self, test: ast.AST, what: str) -> None:
        self._scan_expr_for_flags(test)
        bare = test.operand if isinstance(test, ast.UnaryOp) and \
            isinstance(test.op, ast.Not) else test
        if isinstance(bare, ast.Name) and bare.id in self.containers:
            return                     # a container's truth: its length
        if self.expr_tainted(test):
            self._flag(test, "assert" if what == "assert" else "branch",
                       f"Python `{what}` on a tensor reads it back to the "
                       "host")

    # ------------------------------------------------------- statements
    def run(self) -> None:
        self._walk_body(self.rec.node.body)

    def _walk_body(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self._walk_stmt(stmt)

    def _walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (*FuncDef, ast.ClassDef)):
            return                       # nested defs analysed separately
        if isinstance(stmt, ast.Assign):
            self._scan_expr_for_flags(stmt.value)
            if len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], (ast.Tuple, ast.List)) \
                    and isinstance(stmt.value, (ast.Tuple, ast.List)) \
                    and len(stmt.targets[0].elts) == len(stmt.value.elts):
                for el, v in zip(stmt.targets[0].elts, stmt.value.elts):
                    self._assign(el, v)
            else:
                for t in stmt.targets:
                    self._scan_expr_for_flags(t)
                    self._assign(t, stmt.value)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            self._scan_expr_for_flags(stmt.value)
            if stmt.value is None:
                return
            if isinstance(stmt, ast.AugAssign) and \
                    self.expr_tainted(stmt.target):
                return                   # stays a tensor
            self._assign(stmt.target, stmt.value)
        elif isinstance(stmt, ast.If):
            self._test(stmt.test, "if")
            narrowed = self._narrowed(stmt.test)
            host = narrowed - self.host
            self.tainted -= narrowed
            self.host |= host
            self._walk_body(stmt.body)
            self.tainted |= narrowed & self._was_tainted
            self.host -= host
            self._walk_body(stmt.orelse)
        elif isinstance(stmt, ast.While):
            self._test(stmt.test, "while")
            self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
        elif isinstance(stmt, ast.Assert):
            self._test(stmt.test, "assert")
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr_for_flags(stmt.iter)
            self._bind_loop_target(stmt.target, stmt.iter)
            self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_expr_for_flags(item.context_expr)
                if item.optional_vars is not None and \
                        self.expr_tainted(item.context_expr):
                    self._taint_target(item.optional_vars)
            self._walk_body(stmt.body)
        elif isinstance(stmt, ast.Try):
            self._walk_body(stmt.body)
            for h in stmt.handlers:
                self._walk_body(h.body)
            self._walk_body(stmt.orelse)
            self._walk_body(stmt.finalbody)
        elif isinstance(stmt, (ast.Expr, ast.Return)):
            self._scan_expr_for_flags(stmt.value)
        elif isinstance(stmt, ast.Raise):
            pass                         # the message of a failing path
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._scan_expr_for_flags(child)


def taint_function(rec: FunctionRecord, imports: ImportMap, resolve=None
                   ) -> Tuple[Set[str], List[TaintFlag]]:
    """Taint a function's tensors; returns (tainted names, host-sync
    flags).  ``resolve(call)`` -> the analysed function a call runs (or
    None): its return annotation then says whether the result is a
    tensor."""
    w = _TaintWalker(rec, imports, resolve)
    w.run()
    return w.tainted, w.flags


def node_in(node: ast.AST, region: ast.AST) -> bool:
    """Whether ``node`` lies within ``region``'s lines."""
    return (region.lineno <= node.lineno
            <= (region.end_lineno or region.lineno))


# ---------------------------------------------------------------------------
# Free variables / derivation roots (TPR002, TPR005)
# ---------------------------------------------------------------------------


def bound_names(rec: FunctionRecord) -> Set[str]:
    """Names bound inside a function: params, assignments, loop targets,
    nested defs, imports, withitems, comprehension targets."""
    out: Set[str] = set(rec.all_params())
    for node in ast.walk(rec.node):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for leaf in ast.walk(t):
                    if isinstance(leaf, ast.Name):
                        out.add(leaf.id)
        elif isinstance(node, ast.For):
            for leaf in ast.walk(node.target):
                if isinstance(leaf, ast.Name):
                    out.add(leaf.id)
        elif isinstance(node, ast.comprehension):
            for leaf in ast.walk(node.target):
                if isinstance(leaf, ast.Name):
                    out.add(leaf.id)
        elif isinstance(node, FuncDef) and node is not rec.node:
            out.add(node.name)
        elif isinstance(node, ast.withitem) and node.optional_vars:
            for leaf in ast.walk(node.optional_vars):
                if isinstance(leaf, ast.Name):
                    out.add(leaf.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ExceptHandler) and node.name:
            out.add(node.name)
    return out


def free_names(rec: FunctionRecord) -> Set[str]:
    """Name loads in a function body not bound within the function."""
    bound = bound_names(rec)
    frees: Set[str] = set()
    for node in ast.walk(rec.node):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id not in bound:
            frees.add(node.id)
    return frees


def assignments_of(func_node: ast.AST) -> Dict[str, List[ast.expr]]:
    """name -> list of RHS expressions assigned to it, shallow walk of
    one function body (nested defs excluded)."""
    out: Dict[str, List[ast.expr]] = {}

    def visit(body):
        for stmt in body:
            if isinstance(stmt, FuncDef):
                continue
            if isinstance(stmt, ast.Assign):
                if len(stmt.targets) == 1 and \
                        isinstance(stmt.targets[0], (ast.Tuple, ast.List)) \
                        and isinstance(stmt.value, (ast.Tuple, ast.List)) \
                        and len(stmt.targets[0].elts) == \
                        len(stmt.value.elts):
                    for t, v in zip(stmt.targets[0].elts,
                                    stmt.value.elts):
                        for leaf in ast.walk(t):
                            if isinstance(leaf, ast.Name):
                                out.setdefault(leaf.id, []).append(v)
                    continue
                for t in stmt.targets:
                    for leaf in ast.walk(t):
                        if isinstance(leaf, ast.Name):
                            out.setdefault(leaf.id, []).append(stmt.value)
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)) and \
                    isinstance(stmt.target, ast.Name) and \
                    stmt.value is not None:
                out.setdefault(stmt.target.id, []).append(stmt.value)
            elif isinstance(stmt, ast.For):
                for leaf in ast.walk(stmt.target):
                    if isinstance(leaf, ast.Name):
                        out.setdefault(leaf.id, []).append(stmt.iter)
                visit(stmt.body)
                visit(stmt.orelse)
            elif isinstance(stmt, (ast.If, ast.While)):
                visit(stmt.body)
                visit(stmt.orelse)
            elif isinstance(stmt, ast.With):
                visit(stmt.body)
            elif isinstance(stmt, ast.Try):
                visit(stmt.body)
                for h in stmt.handlers:
                    visit(h.body)
                visit(stmt.orelse)
                visit(stmt.finalbody)

    visit(func_node.body)
    return out


def name_loads(e: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(e)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}

