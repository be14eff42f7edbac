"""Segment Gauss-Newton sums of the flat path: the CUDA kernel's wrapper
and its plain PyTorch versions (port of the reference's XLA segment
reduction, ``fia_tpu/influence/engine.py:_flat_fn``'s ``accum``,
``body_scatter`` and ``body_onehot``; the kernel is
``csrc/segment_hessian.cu``).

For every query segment t of the flat axis,

    HH[t]   = Σ_{s∈t} (wv_s g_s) g_sᵀ     (T, d, d)
    sabe[t] = Σ_{s∈t} abe_s               (T,)

from which the engine forms the damped block Hessians.

The kernel's order. A segment's rows are cut into pieces of
:func:`piece_rows` ``(d)`` rows counted from the segment's own start;
each piece is summed in row order and the piece partials are added in
piece order, ((p0 + p1) + p2) + …. The rule is a function of d alone,
so a segment's bits depend on neither the batch nor where the segment
sits on the flat axis. The plain version with ``piece=piece_rows(d)``
does the same operations in the same order, and the kernel is held to
it bit for bit: both compute the upper triangle, entry (i, j), i <= j,
as Σ (wv g_i) g_j, and mirror it (under the sampled rung's weights n/m
the lower sums Σ (wv g_j) g_i would round otherwise).

On the CPU, :func:`segment_sums` (and so the engine's
``flat_accum="auto"``) keeps the row-order scatter form, the reference's
``body_scatter``: the card's pieced order and the CPU's row order are
two orders of the same float32 sums, and card against CPU is a
tolerance comparison.

Operands:
  g        (S, d) float32  the flat rows' block gradients
  t        (S,)   int32    segment id of each row (scatter and one-hot
                           forms)
  wv, abe  (S,)   float32  validity weight and a·b·e of each row
  off      (T+1,) int64    segment row offsets, clamped to S (kernel and
                           pieced form)
"""

from __future__ import annotations

import ctypes
import sys

import torch

from fia_tpu_torch.influence.kernels import common

#: launches of the CUDA kernels by :func:`segment_sums` in this process
#: (two a call: the pieces, then their combination), and launches recorded
#: into CUDA graphs (:func:`common.count_launch`)
launches = 0
captured = 0

_ARGTYPES = ([ctypes.c_void_p] * 8
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_void_p])
# the kernel's 64-wide tiles above d = 64, upper triangle only, on
# gridDim.y (< 2^16)
MAX_D = 64 * 361
#: rows of a piece at d <= 64, where one block holds the whole d x d block
PIECE_ROWS_BASE = 256


def piece_rows(d: int) -> int:
    """Rows of one piece of a segment at block size ``d``: 256 times the
    kernel's count of 64 × 64 tiles on or above the diagonal, so a block
    walks ~256 rows at d ≤ 64 and, where many tiles already fill the
    card, each tile's walk is no shorter. A function of d alone: the
    summation order, and so the bits, must not follow the batch."""
    n = -(-int(d) // 64)
    return PIECE_ROWS_BASE * (n * (n + 1) // 2)


def segment_rows(off, S: int):
    """``(r0, r1)`` (T,) int64: the rows [r0, r1) of each segment, the
    offsets clamped to S as the kernel reads them."""
    off = off.to(torch.int64).clamp(max=S)
    r1 = off[1:]
    return torch.minimum(off[:-1], r1), r1


def piece_counts(off, S: int, piece: int) -> torch.Tensor:
    """(T,) pieces of each segment: ceil(rows / piece), and 1 for an
    empty segment (whose piece 0 writes its zeros)."""
    r0, r1 = segment_rows(off, S)
    return torch.clamp(
        torch.div(r1 - r0 + piece - 1, piece, rounding_mode="floor"), min=1)


def _pieced(g, wv, abe, off, piece: int):
    """The pieced order: every piece's rows summed in row order (one row
    of every live piece a step), then each segment's partials added in
    piece order. Elementwise float32 products and sums only, so the bits
    are the same on the CPU and on the card."""
    S, d = g.shape
    T = off.shape[0] - 1
    dev = g.device
    r0, r1 = segment_rows(off, S)
    n = piece_counts(off, S, piece)
    seg = torch.repeat_interleave(torch.arange(T, device=dev), n)
    first = torch.cumsum(n, 0) - n  # each segment's piece 0
    q = torch.arange(seg.numel(), device=dev) - first[seg]
    start = r0[seg] + q * piece
    length = torch.clamp(torch.clamp(r1[seg] - start, max=piece), min=0)
    acc = g.new_zeros((seg.numel(), d, d))
    sa = g.new_zeros((seg.numel(),))
    steps = int(length.max()) if seg.numel() else 0
    for k in range(steps):
        live = torch.nonzero(length > k).squeeze(1)
        rows = start[live] + k
        gr = g[rows]
        acc[live] += (gr * wv[rows][:, None])[:, :, None] * gr[:, None, :]
        sa[live] += abe[rows]
    HH, sabe = acc[first], sa[first]
    for k in range(1, int(n.max()) if T else 0):
        live = torch.nonzero(n > k).squeeze(1)
        HH[live] += acc[first[live] + k]
        sabe[live] += sa[first[live] + k]
    # the kernel's definition: entry (i, j), i <= j, is Σ (wv g_i) g_j and
    # (j, i) its mirror. The lower entries summed above are Σ (wv g_j) g_i,
    # the same bits only where wv is 0 or 1, not under the sampled rung's
    # weights n/m
    lo = torch.tril_indices(d, d, -1, device=dev)
    HH[:, lo[0], lo[1]] = HH[:, lo[1], lo[0]]
    return HH, sabe


def segment_sums_reference(g, t, wv, abe, T: int, chunk: int,
                           onehot: bool = False, piece: int | None = None,
                           off=None):
    """The plain versions: ``(HH, sabe)``.

    ``piece=None``, the default (the reference's ``body_scatter``, the
    CPU form): chunk by chunk, the chunk's (chunk, d²) outer products are
    scatter-added by segment, each entry in row order on the CPU (on CUDA
    ``index_add_`` adds with atomics, in no fixed order). ``onehot`` (the
    reference's ``body_onehot``): a (T, chunk) one-hot times the outer
    products in one float32 matrix product a chunk, ~2·T·S·d² flops; its
    bits are fixed only for a fixed geometry (T, S and the rows' places
    in the chunks). ``piece=P`` (the kernel's order, needs ``off``; reads
    neither ``t`` nor ``chunk``): each segment's pieces of P rows from
    its start summed in row order, the partials added in piece order,
    the same bits on either device."""
    if piece is not None:
        if onehot:
            raise ValueError("the one-hot form has no pieced order")
        if off is None:
            raise ValueError("the pieced form needs the segment offsets")
        if int(piece) < 1:
            raise ValueError(f"piece must be >= 1, got {piece}")
        if off.shape[0] != T + 1:
            raise ValueError(f"off has {off.shape[0]} entries, not T + 1 = "
                             f"{T + 1}")
        return _pieced(g, wv, abe, off, int(piece))
    S, d = g.shape
    acc = g.new_zeros((T, d * d))
    s_abe = g.new_zeros((T,))
    ids = torch.arange(T, device=g.device, dtype=t.dtype)
    for c0 in range(0, S, chunk):
        gc, tc = g[c0 : c0 + chunk], t[c0 : c0 + chunk]
        wc, ac = wv[c0 : c0 + chunk], abe[c0 : c0 + chunk]
        outer = ((gc * wc[:, None])[:, :, None] * gc[:, None, :]).reshape(
            -1, d * d
        )
        if onehot:
            oh = (tc[:, None] == ids[None, :]).to(g.dtype)  # (chunk, T)
            acc.addmm_(oh.T, outer)
            s_abe += torch.sum(oh * ac[:, None], dim=0)
        else:
            tl = tc.long()
            acc.index_add_(0, tl, outer)
            s_abe.index_add_(0, tl, ac)
    return acc.reshape(T, d, d), s_abe


def scratch_slots(S: int, piece: int) -> int:
    """Scratch slots the kernel may fill on an S-row axis: a segment's
    piece q >= 1 sits in slot off[t] // piece + q - 1, below
    ceil(S / piece) - 1."""
    return max(-(-S // piece) - 1, 0)


def _check(g, wv, abe, off) -> None:
    S, d = g.shape
    want = {
        "g": (g, torch.float32, (S, d)),
        "wv": (wv, torch.float32, (S,)),
        "abe": (abe, torch.float32, (S,)),
        "off": (off, torch.int64, (off.shape[0],)),
    }
    for name, (x, dtype, shape) in want.items():
        if x.device != g.device:
            raise ValueError(f"{name} is on {x.device}, g on {g.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if off.shape[0] < 1:
        raise ValueError("off needs T + 1 >= 1 entries")
    if d > MAX_D:
        raise ValueError(f"block size {d} beyond the kernel's {MAX_D}")


def segment_sums(g, t, wv, abe, off, chunk: int):
    """``(HH, sabe)`` of every segment. CUDA tensors launch the kernel's
    two passes on the current stream, which read ``off``, in pieces of
    :func:`piece_rows` ``(d)`` rows (or raise); CPU tensors take the
    row-order scatter form over ``t`` in ``chunk``-row pieces."""
    T = off.shape[0] - 1
    if g.device.type == "cpu":
        return segment_sums_reference(g, t, wv, abe, T, chunk)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    _check(g, wv, abe, off)
    S, d = g.shape
    piece = piece_rows(d)
    HH = torch.empty((T, d, d), dtype=torch.float32, device=g.device)
    sabe = torch.empty((T,), dtype=torch.float32, device=g.device)
    if T == 0:
        return HH, sabe
    slots = scratch_slots(S, piece)
    part = torch.empty((slots, d, d), dtype=torch.float32, device=g.device)
    part_abe = torch.empty((slots,), dtype=torch.float32, device=g.device)
    fn = common.load_function("segment_hessian", "fia_segment_hessian",
                              _ARGTYPES)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(g.data_ptr(), wv.data_ptr(), abe.data_ptr(), off.data_ptr(),
                HH.data_ptr(), sabe.data_ptr(), part.data_ptr(),
                part_abe.data_ptr(), S, T, d, piece, stream)
    if rc != 0:
        raise RuntimeError(f"segment_hessian kernel launch failed: "
                           f"cudaError {rc}")
    me = sys.modules[__name__]
    common.count_launch(me)  # the pieces
    common.count_launch(me)  # their combination
    return HH, sabe
