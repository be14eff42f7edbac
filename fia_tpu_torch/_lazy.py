"""Lazy package re-exports: a package's ``__getattr__`` imports the
module that holds a re-exported name on first use, so importing the
package loads no more than it did (no engine, no kernel wrapper) and no
import cycle can form."""

from __future__ import annotations

import importlib
import sys


def lazy_exports(package: str, table: dict[str, str]):
    """``(__getattr__, __dir__)`` for ``package``: ``table`` maps each
    re-exported name to the module that defines it; a name equal to the
    module's last component is that module itself (a submodule)."""

    def __getattr__(name: str):
        path = table.get(name)
        if path is None:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        mod = importlib.import_module(path)
        return mod if path.rsplit(".", 1)[-1] == name else getattr(mod, name)

    def __dir__():
        return sorted(set(table) | set(vars(sys.modules[package])))

    return __getattr__, __dir__
