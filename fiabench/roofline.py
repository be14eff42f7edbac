"""The least time an H100 could take for the work of a window, and the
operations a query needs.

Peaks are NVIDIA's published H100 SXM figures at 700 W (dense, no
sparsity): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of
HBM. The least time of a call is the larger of its operations over the
FLOP peak and its bytes over the bandwidth, each input byte counted read
once and each output byte written once (the arithmetic of the program's
``chip_smoke.py`` bounds, copied here). Every count is taken from the
shapes of a dispatch, described by a ``Launch``; nothing reads the
program.
"""

from __future__ import annotations

from dataclasses import dataclass

from fiabench.reference import family

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


@dataclass(frozen=True)
class Launch:
    """One query shard's flat program: its padded geometry and the work
    its real queries hold. ``rows`` real related rows (a row equal to
    its query's pair counts twice, once from each side) over ``queries``
    real queries; ``user_rows`` / ``item_rows`` the rows matching their
    query's user / item, ``both_rows`` those matching both."""

    t_pad: int
    s_pad: int
    queries: int
    rows: int
    user_rows: int
    item_rows: int
    both_rows: int


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def table_bytes(cfg: dict) -> int:
    """Bytes of the weights a score kernel reads whole, float32."""
    total = 0
    for shape, _ in family(cfg).param_specs(cfg).values():
        n = 1
        for s in shape:
            n *= s
        total += 4 * n
    return total


def mf_scores_s(cfg: dict, ln: Launch) -> float:
    """The MF score kernel: tx (t, 2) and rel_x (S, 2) int32, t, e, wv
    (S,), B (t, d + 2), the tables P and Q read, (S,) scores written;
    4k + 10 operations a row."""
    k = cfg["embedding_size"]
    d = 2 * k + 2
    S, T = ln.s_pad, ln.t_pad
    U, I = cfg["num_users"], cfg["num_items"]
    nb = (T * 2 * 4 + S * 4 + S * 8 + S * 4 + S * 4 + T * (d + 2) * 4
          + (U + I) * k * 4 + S * 4)
    return bound_s(nb, S * (4 * k + 10))


def ncf_scores_s(cfg: dict, ln: Launch) -> float:
    """The NCF score kernel, counted by what these rows need once every
    product of the query alone is formed once a query: a row matching
    one side of its query needs the other side's half of [pm|qm] W1
    (k² FMAs; none where it matches both), z2 and dz2 W2ᵀ (2·k·k2), 2k
    a matching side for the dots, and 5 operations of the epilogue; a
    query 4k² FMAs and 2k products. Bytes: the operands as for MF (B
    is (t, 4k + 2)) and every weight once."""
    k = cfg["embedding_size"]
    k2 = k // 2
    d = 4 * k
    S, T = ln.s_pad, ln.t_pad
    # every related row matches its query's user or item
    fma = ((ln.rows - ln.both_rows) * k * k + ln.rows * 2 * k * k2
           + (ln.user_rows + ln.item_rows) * 2 * k + T * 4 * k * k)
    flops = 2 * fma + 5 * ln.rows + T * 2 * k
    nb = (T * 2 * 4 + S * 4 + S * 8 + S * 4 + S * 4 + T * (d + 2) * 4
          + table_bytes(cfg) + S * 4)
    return bound_s(nb, flops)


def segment_hessian_s(cfg: dict, ln: Launch, d: int) -> float:
    """The segment Hessian sums: the rows inside a segment read once (g,
    wv, abe), the offsets, the (t, d, d) sums and (t,) sabe written;
    one multiply-add a row for each distinct entry of the symmetric
    block."""
    rows = min(ln.rows, ln.s_pad)
    T = ln.t_pad
    nb = rows * (d * 4 + 8) + (T + 1) * 8 + T * d * d * 4 + T * 4
    return bound_s(nb, rows * d * (d + 1))


def solve_s(cfg: dict, ln: Launch, d: int) -> float:
    """The batched LU solve of every padded query: 2d³/3 + 2d²
    operations a query; its (d, d) block and right side read, the
    solution and the pivots written."""
    T = ln.t_pad
    return bound_s(T * (d * d + 3 * d) * 4,
                   T * (2 * d ** 3 / 3 + 2 * d * d))


def query_flops(cfg: dict, rows: int, queries: int, d: int) -> float:
    """Model operations of answered queries, the same whatever computes
    them: a related row's gradient and residual (the family's
    ``row_flops``), its Hessian term d(d + 1) and its score's dot and
    epilogue 2d + 4; a query's solve 2d³/3 + 2d²."""
    per_row = family(cfg).row_flops(cfg) + d * (d + 1) + 2 * d + 4
    return rows * per_row + queries * (2 * d ** 3 / 3 + 2 * d * d)
