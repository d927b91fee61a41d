"""Lazy re-exports: a sub-package lists ``name -> module`` and the module is
imported when the name is first asked for."""
from __future__ import annotations

import importlib
from typing import Dict


def lazy_exports(package: str, table: Dict[str, str]):
    """``(__getattr__, __dir__)`` for a package whose public names live in
    the sub-modules ``table`` maps them to."""

    def __getattr__(name):
        try:
            mod = table[name]
        except KeyError:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}") from None
        return getattr(importlib.import_module(f"{package}.{mod}"), name)

    def __dir__():
        return sorted(table)

    return __getattr__, __dir__
