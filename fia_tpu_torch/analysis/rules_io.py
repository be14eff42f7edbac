"""FIA101 — raw-write discipline.

Every persisted byte in this repo goes through ``utils/io.py`` (the
fsync'd atomic-rename primitives) or ``reliability/artifacts.py`` (the
checksummed-manifest publish on top). A raw ``open(.., "w")`` anywhere
else is exactly how the r5 chain lost artifacts: a kill mid-write
leaves a torn file at the published name and the reader trusts it.

This rule replaces ``scripts/check_raw_writes.sh`` (a grep over two
byte patterns) with precise AST detection over the full raw-write
surface:

- ``open(path, "w"/"wb"/"w+"/"wb+"/"xb"/"x")`` (positional or
  ``mode=``). Append mode (``"a"``) is allowed by design: append-only
  JSONL event logs and journals are the repo's crash-tolerant logging
  idiom (a torn tail line is detected and skipped by every reader).
- ``np.save`` / ``np.savez`` / ``np.savez_compressed`` / ``np.savetxt``
- ``json.dump`` (to a file handle; ``json.dumps`` is a string, fine)
- ``pickle.dump``
- ``<path>.write_text(...)`` / ``<path>.write_bytes(...)``
- ``os.fdopen(fd, "w"/"wb")`` (the mkstemp-then-fdopen variant)
"""

from __future__ import annotations

import ast

from fia_tpu_torch.analysis import config
from fia_tpu_torch.analysis.core import FileRule, SourceFile, register
from fia_tpu_torch.analysis.visitor import RuleVisitor, call_name, const_str

_WRITE_MODES = {"w", "wb", "w+", "wb+", "w+b", "x", "xb", "wt"}

_NP_WRITERS = {"save", "savez", "savez_compressed", "savetxt"}

_ROUTE = ("; route through fia_tpu_torch.utils.io (save_npz_atomic / "
          "save_json_atomic / save_text_atomic / savetxt_atomic) or "
          "reliability.artifacts.publish_npz")


def _mode_arg(node: ast.Call, pos: int) -> str | None:
    """The literal mode argument of an open()-style call, if any."""
    if len(node.args) > pos:
        return const_str(node.args[pos])
    for kw in node.keywords:
        if kw.arg == "mode":
            return const_str(kw.value)
    return None


class _IoVisitor(RuleVisitor):
    def visit_Call(self, node: ast.Call) -> None:
        cn = call_name(node)
        if cn == "open":
            mode = _mode_arg(node, 1)
            if mode in _WRITE_MODES:
                self.flag(node, f"raw open(.., {mode!r}) write" + _ROUTE)
        elif cn == "os.fdopen":
            mode = _mode_arg(node, 1)
            if mode in _WRITE_MODES:
                self.flag(node, f"raw os.fdopen(.., {mode!r}) write" + _ROUTE)
        elif cn in ("json.dump", "pickle.dump"):
            self.flag(node, f"raw {cn} to a file handle" + _ROUTE)
        elif cn is not None and cn.split(".", 1)[0] in ("np", "numpy"):
            tail = cn.split(".")[-1]
            if tail in _NP_WRITERS and len(cn.split(".")) == 2:
                self.flag(node, f"raw {cn} write" + _ROUTE)
        elif isinstance(node.func, ast.Attribute) and node.func.attr in (
            "write_text", "write_bytes"
        ):
            self.flag(
                node, f"raw .{node.func.attr}(...) write" + _ROUTE
            )
        self.generic_visit(node)


@register
class RawWriteRule(FileRule):
    """Persisted writes must go through the artifact integrity layer."""

    id = "FIA101"
    name = "raw-write"

    def check(self, sf: SourceFile):
        if sf.rel.endswith(config.RAW_WRITE_ALLOWED):
            return []
        return _IoVisitor(self.id, sf).run()
