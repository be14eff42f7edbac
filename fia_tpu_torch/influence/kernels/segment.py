"""Segment Gauss-Newton sums of the flat path: the CUDA kernel's wrapper
and its plain PyTorch versions (port of the reference's XLA segment
reduction, ``fia_tpu/influence/engine.py:_flat_fn``'s ``accum``,
``body_scatter`` and ``body_onehot``; the kernel is
``csrc/segment_hessian.cu``).

For every query segment t of the flat axis,

    HH[t]   = Σ_{s∈t} (wv_s g_s) g_sᵀ     (T, d, d)
    sabe[t] = Σ_{s∈t} abe_s               (T,)

from which the engine forms the damped block Hessians. The kernel sums
each entry over the segment's own rows in row order, so its bits depend
on neither the batch nor where the segment sits on the flat axis.

Operands:
  g        (S, d) float32  the flat rows' block gradients
  t        (S,)   int32    segment id of each row (plain versions)
  wv, abe  (S,)   float32  validity weight and a·b·e of each row
  off      (T+1,) int64    segment row offsets, clamped to S (kernel)
"""

from __future__ import annotations

import ctypes
import sys

import torch

from fia_tpu_torch.influence.kernels import common

#: launches of the CUDA kernel by :func:`segment_sums` in this process, and
#: launches recorded into CUDA graphs (:func:`common.count_launch`)
launches = 0
captured = 0

_ARGTYPES = ([ctypes.c_void_p] * 6
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# the kernel's 64-wide tiles, upper triangle only, on gridDim.y (< 2^16)
MAX_D = 64 * 361


def segment_sums_reference(g, t, wv, abe, T: int, chunk: int,
                           onehot: bool = False):
    """The plain versions, chunk by chunk in row order: ``(HH, sabe)``.

    Default (the reference's ``body_scatter``, the CPU form): the chunk's
    (chunk, d²) outer products are scatter-added by segment, each entry in
    row order on the CPU (on CUDA ``index_add_`` adds with atomics, in no
    fixed order). ``onehot`` (the reference's ``body_onehot``): a
    (T, chunk) one-hot times the outer products in one float32 matrix
    product a chunk, ~2·T·S·d² flops; its bits are fixed only for a fixed
    geometry (T, S and the rows' places in the chunks)."""
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
    """``(HH, sabe)`` of every segment. CUDA tensors launch the kernel on
    the current stream, which reads ``off`` (or raise); CPU tensors take
    the scatter form over ``t`` in ``chunk``-row pieces."""
    T = off.shape[0] - 1
    if g.device.type == "cpu":
        return segment_sums_reference(g, t, wv, abe, T, chunk)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    _check(g, wv, abe, off)
    S, d = g.shape
    HH = torch.empty((T, d, d), dtype=torch.float32, device=g.device)
    sabe = torch.empty((T,), dtype=torch.float32, device=g.device)
    if T == 0:
        return HH, sabe
    fn = common.load_function("segment_hessian", "fia_segment_hessian",
                              _ARGTYPES)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(g.data_ptr(), wv.data_ptr(), abe.data_ptr(), off.data_ptr(),
                HH.data_ptr(), sabe.data_ptr(), S, T, d, stream)
    if rc != 0:
        raise RuntimeError(f"segment_hessian kernel launch failed: "
                           f"cudaError {rc}")
    common.count_launch(sys.modules[__name__])
    return HH, sabe
