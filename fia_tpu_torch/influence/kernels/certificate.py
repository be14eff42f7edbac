"""The sampled rung's per-query certificate sums: the CUDA kernel's
wrapper and its plain PyTorch version (port of the reference's XLA
segment reductions, ``fia_tpu/influence/sampled.py:segment_sample_std``
and the ``gx``/``h``/``gnorm``/segment maxima of
``fia_tpu/influence/engine.py:_sampled_fn``; the kernel is
``csrc/segment_certificate.cu``).

For every query segment t of the flat axis (rows [off[t], off[t+1])):

    gx_s    = g_s · ihvp_t
    h_s     = wv_s g_s gx_s + abe_s Cx_t           (d values a row)
    σ̂_t     = sample std of h_s over the rows with ws_s > 0 (m_t of them)
    gmax_t  = max(0, max_s wv_s · 2|e_s| · ‖g_s‖)
    wmax_t  = max(0, max_s wv_s)

``abe`` is a·b·e without the sample weights (the reference's ``ab * e``).
A non-finite h on any row of a segment, sampled or not, makes its σ̂ NaN,
as the reference's multiply by the 0/1 mask does; the engine's NaN ladder
then handles the payload.

The kernel's order depends only on a segment's own rows: pieces of
:data:`CERT_PIECE_ROWS` rows from the segment's start, one block each,
combined in piece order by a second launch; so a query's bound is the
same bits in any batch. The plain version (the CPU path, and the
kernel's reference on the card) does the same arithmetic in another
order: each dot a column loop (elementwise, the same bits on any device),
the segment sums a row-order scatter on the CPU (on CUDA ``index_add_``
adds with atomics, in no fixed order). Kernel against plain is a
tolerance comparison.

Operands:
  g           (S, d) float32  the flat rows' block gradients
  t           (S,)   int32    segment id of each row (plain version)
  ihvp, Cx    (T, d) float32  each query's iHVP and C·iHVP
  wv, ws, abe, e (S,) float32 validity, sample weight, a·b·e, residual
  off         (T+1,) int64    segment row offsets, clamped to S
  m           (T,)   int32    each query's sample size
"""

from __future__ import annotations

import ctypes
import sys

import torch

from fia_tpu_torch.influence.kernels import common
from fia_tpu_torch.influence.kernels import segment as Kseg

#: launches of the CUDA kernels by :func:`segment_certificate` in this
#: process (two a call: the pieces, then each segment's combination), and
#: launches recorded into CUDA graphs (:func:`common.count_launch`)
launches = 0
captured = 0
LAUNCHES_PER_CALL = 2

#: rows of a piece: a constant, so a segment's order follows its own rows
CERT_PIECE_ROWS = 256
MAX_D = 1024
#: a piece slot's scalars: M2 about the piece's mean, sampled count,
#: gmax, wmax
SLOT_STATS = 4

_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_void_p]


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(S,) row dots as a column loop, (((a0 b0) + a1 b1) + ...):
    elementwise only, so a row's bits follow neither its batch nor its
    alignment, on either device."""
    acc = a[:, 0] * b[:, 0]
    for j in range(1, a.shape[1]):
        acc = acc + a[:, j] * b[:, j]
    return acc


def _segment_max(x: torch.Tensor, t: torch.Tensor, T: int) -> torch.Tensor:
    """max(0, max over each segment's rows), NaN propagating."""
    return x.new_zeros((T,)).scatter_reduce_(0, t, x, "amax",
                                             include_self=True)


def segment_certificate_reference(g, t, ihvp, Cx, wv, ws, abe, e, off, m):
    """The plain version: ``(sigma, gmax, wmax)``, each (T,) float32.
    Rows past the last segment (the flat pad) belong to none."""
    S, d = g.shape
    T = off.shape[0] - 1
    if T == 0:
        z = g.new_zeros((0,))
        return z, z, z
    _, r1 = Kseg.segment_rows(off, S)
    total = int(r1[-1])
    g, wv, ws, abe, e = (x[:total] for x in (g, wv, ws, abe, e))
    tl = t[:total].long()
    gx = _rowdot(g, ihvp[tl])
    h = wv[:, None] * g * gx[:, None] + abe[:, None] * Cx[tl]
    mask = (ws > 0).to(g.dtype)
    mf = m.to(g.dtype)
    mu = g.new_zeros((T, d)).index_add_(0, tl, h * mask[:, None])
    mu = mu / torch.clamp(mf, min=1.0)[:, None]
    diff = (h - mu[tl]) * mask[:, None]
    ss = g.new_zeros((T,)).index_add_(0, tl, _rowdot(diff, diff))
    sigma = torch.sqrt(ss / torch.clamp(mf - 1.0, min=1.0))
    gnorm = torch.sqrt(_rowdot(g, g))
    gmax = _segment_max(wv * 2.0 * torch.abs(e) * gnorm, tl, T)
    wmax = _segment_max(wv, tl, T)
    return sigma, gmax, wmax


def scratch_slots(S: int, T: int) -> int:
    """Scratch slots of the kernel's piece partials: piece q of segment t
    sits in slot off[t] // P + t + q, below S // P + T + 1 (P =
    :data:`CERT_PIECE_ROWS`)."""
    return S // CERT_PIECE_ROWS + T + 1


def _check(g, ihvp, Cx, wv, ws, abe, e, off, m) -> None:
    S, d = g.shape
    T = off.shape[0] - 1
    want = {
        "g": (g, torch.float32, (S, d)),
        "ihvp": (ihvp, torch.float32, (T, d)),
        "Cx": (Cx, torch.float32, (T, d)),
        "wv": (wv, torch.float32, (S,)),
        "ws": (ws, torch.float32, (S,)),
        "abe": (abe, torch.float32, (S,)),
        "e": (e, torch.float32, (S,)),
        "off": (off, torch.int64, (T + 1,)),
        "m": (m, torch.int32, (T,)),
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
    if d > MAX_D:
        raise ValueError(f"block size {d} beyond the kernel's {MAX_D}")


def segment_certificate(g, t, ihvp, Cx, wv, ws, abe, e, off, m):
    """``(sigma, gmax, wmax)`` of every segment. CUDA tensors launch the
    kernel's two passes on the current stream, which read ``off`` (or
    raise); CPU tensors take the plain version over ``t``."""
    if g.device.type == "cpu":
        return segment_certificate_reference(g, t, ihvp, Cx, wv, ws, abe, e,
                                             off, m)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    _check(g, ihvp, Cx, wv, ws, abe, e, off, m)
    S, d = g.shape
    T = off.shape[0] - 1
    out = [torch.empty((T,), dtype=torch.float32, device=g.device)
           for _ in range(3)]
    if T == 0:
        return tuple(out)
    slots = scratch_slots(S, T)
    part = torch.empty((slots, d), dtype=torch.float32, device=g.device)
    part_s = torch.empty((slots, SLOT_STATS), dtype=torch.float32,
                         device=g.device)
    fn = common.load_function("segment_certificate",
                              "fia_segment_certificate", _ARGTYPES)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(g.data_ptr(), ihvp.data_ptr(), Cx.data_ptr(), wv.data_ptr(),
                ws.data_ptr(), abe.data_ptr(), e.data_ptr(), off.data_ptr(),
                m.data_ptr(), *(o.data_ptr() for o in out), part.data_ptr(),
                part_s.data_ptr(), S, T, d, CERT_PIECE_ROWS, stream)
    if rc != 0:
        raise common.launch_error("segment_certificate", rc)
    me = sys.modules[__name__]
    for _ in range(LAUNCHES_PER_CALL):
        common.count_launch(me)
    return tuple(out)
