"""TPR004 — dtype discipline (the port's RPR004).

The port's correctness story is differential, as the reference's: the
``"torch"`` backend's float64 tick loop, the sweep's float64 flat
evaluator and the sequential engine are the *reference* the float32 /
bf16 device paths are held to.  Two drifts break that story silently:

* a float32 dtype sneaking into the float64 reference set narrows the
  reference itself, so the tolerance checks compare float32 against
  float32 and stop catching device bugs;
* a float64 dtype on a float32 / bf16 device path (the kernel wrappers,
  ``models/``, the server and the trainer) doubles its bytes and runs
  its products on the card's float64 units (~1/16 of its bf16 rate)
  without anyone asking for it.

Host staging like ``np.asarray(x, dtype=np.float64)`` is fine and not
flagged; ``torch.zeros(..., dtype=torch.float64)``, ``x.to(torch.float64)``
and ``x.double()`` on a device path are.  A function of the reference set
that takes ``dtype`` as a parameter is its caller's choice and is not
held to float64, except where :data:`F64_REFERENCE` names it.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import ModuleContext
from repro_torch.analysis.findings import Finding

RULE_ID = "TPR004"
SUMMARY = ("no float32 in the float64 reference set; no silent float64 on "
           "the float32/bf16 device paths")

# (relpath suffix, qualname prefix or None = entire module).  The "torch"
# backend's tick loop and its service terms (float64 unless the engine was
# made float32, which converts at the loop's edges), the sweep's flat
# evaluator, and the sequential engine (sim/engine.py) wherever its dtype
# is not a parameter.
F64_REFERENCE: Tuple[Tuple[str, Optional[str]], ...] = (
    ("sim/engine.py", None),
    ("sim/batch.py", "BatchSimEngine._ticks"),
    ("sim/batch.py", "BatchSimEngine._service_t"),
    ("core/dse.py", "_eval_flat_points_t"),
)

# the float32 / bf16 device paths (relpath suffixes)
DEVICE_PATHS: Tuple[str, ...] = (
    "kernels/flash_attention.py", "kernels/flash_decode.py",
    "kernels/fused_mlp.py", "kernels/ssd_scan.py", "kernels/ops.py",
    "kernels/_common.py", "models/", "runtime/serve.py",
    "runtime/train.py",
)

_F32_TOKENS = {"float32", "float", "single"}
_F64_TOKENS = {"float64", "double"}


def _dtype_token(node: ast.AST, imports: astutil.ImportMap,
                 ) -> Optional[str]:
    """'float32'/'float64' if the node names that dtype, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        if node.value in ("float32", "float64"):
            return node.value
        return None
    dotted = imports.normalize(astutil.dotted_name(node))
    if dotted and (dotted.startswith("torch.")
                   or dotted.startswith("numpy.")):
        last = dotted.rsplit(".", 1)[-1]
        if last in _F32_TOKENS and dotted.startswith("torch."):
            return "float32"
        if last == "float32":
            return "float32"
        if last in _F64_TOKENS:
            return "float64"
    return None


def _reference_scope(ctx: ModuleContext, node: ast.AST) -> Optional[str]:
    """Qualname of the float64 reference scope containing node, or None."""
    for suffix, qual in F64_REFERENCE:
        if not ctx.relpath.endswith(suffix):
            continue
        rec = ctx.enclosing_function(node)
        if qual is None:
            cur = rec
            while cur is not None:
                if "dtype" in cur.all_params():
                    return None
                cur = cur.parent
            return f"module {ctx.relpath}"
        while rec is not None:
            if rec.qualname == qual or \
                    rec.qualname.startswith(qual + "."):
                return qual
            rec = rec.parent
    return None


def _on_device_path(ctx: ModuleContext) -> bool:
    return any(ctx.relpath.endswith(s) if s.endswith(".py")
               else f"/{s}" in f"/{ctx.relpath}" for s in DEVICE_PATHS)


def check(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    device = _on_device_path(ctx)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = ctx.imports.normalize(astutil.dotted_name(node.func))
        method = (node.func.attr if isinstance(node.func, ast.Attribute)
                  else None)
        dtype_args = [a for a in list(node.args)
                      + [kw.value for kw in node.keywords]
                      if _dtype_token(a, ctx.imports) is not None]
        tokens = {_dtype_token(a, ctx.imports) for a in dtype_args}
        if method == "float" and not node.args:
            tokens.add("float32")
        if method == "double" and not node.args:
            tokens.add("float64")
        if not tokens:
            continue
        ref = _reference_scope(ctx, node)
        if ref is not None:
            if "float32" in tokens:
                out.append(ctx.finding(
                    RULE_ID, node,
                    f"float32 introduced inside the float64 reference "
                    f"scope ({ref}) — the reference must stay float64 "
                    "so differential tolerance checks keep meaning"))
            continue
        if "float64" not in tokens or not device:
            continue
        on_torch = bool(callee) and (callee == "torch"
                                     or callee.startswith("torch."))
        if on_torch or method in ("to", "double", "type", "new_zeros",
                                  "new_ones", "new_full", "new_empty",
                                  "new_tensor"):
            out.append(ctx.finding(
                RULE_ID, node,
                f"float64 requested in `{callee or '.' + str(method)}` on "
                "a float32/bf16 device path — doubles its bytes and runs "
                "on the card's float64 units; stage host-side with "
                "np.asarray if the host needs float64"))
    return out
