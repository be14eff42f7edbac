"""The query solver degradation ladder (copy of
``fia_tpu/reliability/policy.py:220-271``).

A non-finite influence payload escalates one rung toward the exact
direct solve (``lissa → cg → direct``, ``schulz → direct``); the ladder
ends at CG (whose negative-curvature freeze never diverges) and then
direct. ``precomputed`` sits ahead of it (any bank trouble falls through)
and ``sampled`` is the certified-approximate rung before ``lissa``.
"""

from __future__ import annotations

QUERY_SOLVER_FALLBACK = {"precomputed": "sampled", "sampled": "lissa",
                         "lissa": "cg", "schulz": "direct",
                         "cg": "direct"}

#: solver names the block engine accepts, ladder-ordered robust-last
BLOCK_SOLVERS = ("precomputed", "sampled", "lissa", "schulz", "cg",
                 "direct")


def next_solver(current: str, fallback: dict[str, str] = QUERY_SOLVER_FALLBACK
                ) -> str | None:
    """The next (more robust) rung under ``current``, or ``None`` at the
    ladder's bottom."""
    return fallback.get(current)


def resolve_solver(requested: str | None, default: str = "direct",
                   supported: tuple[str, ...] = BLOCK_SOLVERS) -> str:
    """``requested`` (``None``: ``default``), walked down the ladder
    until a ``supported`` rung, else the most robust supported one."""
    name = default if requested is None else str(requested)
    seen = set()
    while name not in supported:
        if name in seen:  # ladder cycle guard (config maps are data)
            break
        seen.add(name)
        nxt = next_solver(name)
        if nxt is None:
            break
        name = nxt
    if name not in supported:
        name = supported[-1]
    return name
