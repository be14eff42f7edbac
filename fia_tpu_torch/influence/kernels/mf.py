"""MF fused score: the CUDA kernel's wrapper and its plain PyTorch
version (port of ``fia_tpu/influence/kernels/mf.py:39-79``; the kernel
itself is ``csrc/mf_scores.cu``).

The MF per-row block gradient is closed-form,
``g_s = [a_s Q[item_s] ; b_s P[user_s] ; a_s ; b_s]`` (d = 2k + 2), so
the score dot ``g_s · ihvp_t`` splits into two masked k-wide dots plus
two bias picks, and no (S, d) matrix is needed.

Operands (the kernel's, and the plain version's):
  rel_x (S, 2) int32   the flat rows' own (user, item)
  t     (S,)   int32   owning query of each row (segment id)
  e, wv (S,)   float32 residual and validity weight
  tx    (T, 2) int32   the query pairs (u_t, i_t)
  P, Q  (U, k), (I, k) float32 the embedding tables
  B     (T, 2k + 4) float32 ``[ihvp | reg_dot | n_t]``
"""

from __future__ import annotations

import ctypes
import sys

import torch

from fia_tpu_torch.influence.kernels import common

#: launches of the CUDA kernel by :func:`fused_scores` in this process, and
#: launches recorded into CUDA graphs (:func:`common.count_launch`)
launches = 0
captured = 0

_ARGTYPES = (
    [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
)


def fused_scores_reference(rel_x, t, e, wv, tx, P, Q, B) -> torch.Tensor:
    """The plain PyTorch version of the kernel: (S,) scores."""
    k = P.shape[1]
    d = 2 * k + 2
    t = t.long()
    xu, xi = rel_x[:, 0].long(), rel_x[:, 1].long()
    Bt = B[t]  # (S, d + 2)
    q = tx[t]
    a = (xu == q[:, 0]).to(torch.float32)
    b = (xi == q[:, 1]).to(torch.float32)
    gdot = a * (torch.sum(Q[xi] * Bt[:, :k], dim=1) + Bt[:, 2 * k]) + b * (
        torch.sum(P[xu] * Bt[:, k : 2 * k], dim=1) + Bt[:, 2 * k + 1]
    )
    return common.score_epilogue(gdot, e, wv, Bt, d)


def _check(rel_x, t, e, wv, tx, P, Q, B) -> None:
    S, T, k = rel_x.shape[0], tx.shape[0], P.shape[1]
    want = {
        "rel_x": (rel_x, torch.int32, (S, 2)),
        "t": (t, torch.int32, (S,)),
        "e": (e, torch.float32, (S,)),
        "wv": (wv, torch.float32, (S,)),
        "tx": (tx, torch.int32, (T, 2)),
        "P": (P, torch.float32, (P.shape[0], k)),
        "Q": (Q, torch.float32, (Q.shape[0], k)),
        "B": (B, torch.float32, (T, 2 * k + 4)),
    }
    for name, (x, dtype, shape) in want.items():
        if x.device != rel_x.device:
            raise ValueError(f"{name} is on {x.device}, rel_x on {rel_x.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_scores(rel_x, t, e, wv, tx, P, Q, B) -> torch.Tensor:
    """(S,) MF fused scores. CUDA tensors launch the kernel on the
    current stream (or raise); CPU tensors take the plain version."""
    if rel_x.device.type == "cpu":
        return fused_scores_reference(rel_x, t, e, wv, tx, P, Q, B)
    if rel_x.device.type != "cuda":
        raise ValueError(f"unsupported device {rel_x.device}")
    _check(rel_x, t, e, wv, tx, P, Q, B)
    S, k = rel_x.shape[0], P.shape[1]
    out = torch.empty((S,), dtype=torch.float32, device=rel_x.device)
    if S == 0:
        return out
    fn = common.load_function("mf_scores", "fia_mf_fused_scores", _ARGTYPES)
    vec4 = k % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in (P, Q, B))
    with torch.cuda.device(rel_x.device):
        stream = torch.cuda.current_stream(rel_x.device).cuda_stream
        rc = fn(rel_x.data_ptr(), t.data_ptr(), e.data_ptr(), wv.data_ptr(),
                tx.data_ptr(), P.data_ptr(), Q.data_ptr(), B.data_ptr(),
                out.data_ptr(), S, k, int(vec4), stream)
    if rc != 0:
        raise common.launch_error("mf_scores", rc)
    common.count_launch(sys.modules[__name__])
    return out
