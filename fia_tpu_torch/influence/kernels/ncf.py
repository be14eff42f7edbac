"""NCF fused score: the CUDA kernel's wrapper and its plain PyTorch
version (port of ``fia_tpu/influence/kernels/ncf.py:30-118``; the kernel
itself is ``csrc/ncf_scores.cu``).

The NCF per-row block gradient is one closed-form MLP backward
(:func:`own_backward`, which ``models/ncf.py:NCF.own_grads`` shares):
with z1 = [pm|qm] W1 + b1,
z2 = relu(z1) W2 + b2 and W3 split into its h2 rows w3h (first k/2) and
GMF rows w3g (last k),

    dz2  = [z2 > 0] ⊙ w3h        dhin = ([z1 > 0] ⊙ (dz2 W2ᵀ)) W1ᵀ
    g_s  = [a dhin[:k] ; b dhin[k:] ; a (qg ⊙ w3g) ; b (pg ⊙ w3g)]

so the score dot ``g_s · ihvp_t`` needs the row's four embedding rows
and the MLP weights, and no (S, 4k) matrix.

Operands (the kernel's, and the plain version's):
  rel_x (S, 2) int32     the flat rows' own (user, item)
  t     (S,)   int32     owning query of each row (segment id)
  e, wv (S,)   float32   residual and validity weight
  tx    (T, 2) int32     the query pairs (u_t, i_t)
  P_mlp, P_gmf (U, k); Q_mlp, Q_gmf (I, k)  float32 embedding tables
  W1 (2k, k), b1 (k,), W2 (k, k2), b2 (k2,), W3 (k2 + k, 1) float32,
     k2 = k // 2
  B     (T, 4k + 2) float32 ``[ihvp | reg_dot | n_t]``
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
    [ctypes.c_void_p] * 17 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p]
)
_NAMES = ("rel_x", "t", "e", "wv", "tx", "P_mlp", "Q_mlp", "P_gmf", "Q_gmf",
          "W1", "b1", "W2", "b2", "W3", "B")


#: rows a piece of :func:`rows_product`
ROW_PIECE = 2048


def rows_product(x, W):
    """``x @ W`` for (S, K) rows ``x``, each row's bits independent of S:
    the rows in pieces of ROW_PIECE (the last zero-padded) as one batched
    product. On the card a plain product's kernel is chosen by the row
    count and changes every row's bits with it (seen on an H100 for
    (S, 16) x (16, 8) between S <= 6144 and S >= 8192, and for most of
    NCF's shapes); the batched product's is chosen by the piece, and gave
    the same bits for 2 and 16 pieces at every shape tried."""
    S, K = x.shape
    n = -(-S // ROW_PIECE)
    x = torch.nn.functional.pad(x, (0, 0, 0, n * ROW_PIECE - S))
    out = torch.bmm(x.reshape(n, ROW_PIECE, K), W.expand(n, *W.shape))
    return out.reshape(n * ROW_PIECE, W.shape[1])[:S]


def preactivations(xu, xi, P_mlp, Q_mlp, W1, b1, W2, b2):
    """(S, k) z1 and (S, k2) z2 of the MLP tower of rows (xu, xi), in the
    tables' dtype: the values whose sign sets the relu masks."""
    z1 = rows_product(torch.cat([P_mlp[xu], Q_mlp[xi]], dim=1), W1) + b1
    z2 = rows_product(torch.relu(z1), W2) + b2
    return z1, z2


def own_backward(xu, xi, P_mlp, Q_mlp, W1, b1, W2, b2, W3):
    """(S, 2k) ``dhin = (dpm | dqm)``: the gradient of each row's
    prediction with respect to its own MLP embedding rows. The masks are
    strict, so relu'(0) = 0 as in the reference."""
    k2 = W2.shape[1]
    z1, z2 = preactivations(xu, xi, P_mlp, Q_mlp, W1, b1, W2, b2)
    dz2 = torch.where(z2 > 0, W3[:k2, 0], torch.zeros_like(z2))
    dz1 = torch.where(z1 > 0, rows_product(dz2, W2.T), torch.zeros_like(z1))
    return rows_product(dz1, W1.T)


def fused_scores_reference(rel_x, t, e, wv, tx, P_mlp, Q_mlp, P_gmf, Q_gmf,
                           W1, b1, W2, b2, W3, B) -> torch.Tensor:
    """The plain PyTorch version of the kernel: (S,) scores, in the
    operands' float dtype."""
    k, k2 = P_mlp.shape[1], W2.shape[1]
    d = 4 * k
    t = t.long()
    xu, xi = rel_x[:, 0].long(), rel_x[:, 1].long()
    Bt = B[t]  # (S, d + 2)
    q = tx[t]
    a = (xu == q[:, 0]).to(B.dtype)
    b = (xi == q[:, 1]).to(B.dtype)
    dhin = own_backward(xu, xi, P_mlp, Q_mlp, W1, b1, W2, b2, W3)
    w3g = W3[k2:, 0]
    gdot = a * (
        torch.sum(dhin[:, :k] * Bt[:, :k], dim=1)
        + torch.sum(Q_gmf[xi] * w3g * Bt[:, 2 * k : 3 * k], dim=1)
    ) + b * (
        torch.sum(dhin[:, k:] * Bt[:, k : 2 * k], dim=1)
        + torch.sum(P_gmf[xu] * w3g * Bt[:, 3 * k : d], dim=1)
    )
    return common.score_epilogue(gdot, e, wv, Bt, d)


def _check(*args) -> None:
    rel_x, t, e, wv, tx, P_mlp, Q_mlp, P_gmf, Q_gmf, W1, b1, W2, b2, W3, B = args
    S, T, k = rel_x.shape[0], tx.shape[0], P_mlp.shape[1]
    k2 = k // 2
    U, I = P_mlp.shape[0], Q_mlp.shape[0]
    i32, f32 = torch.int32, torch.float32
    want = (
        (i32, (S, 2)), (i32, (S,)), (f32, (S,)), (f32, (S,)), (i32, (T, 2)),
        (f32, (U, k)), (f32, (I, k)), (f32, (U, k)), (f32, (I, k)),
        (f32, (2 * k, k)), (f32, (k,)), (f32, (k, k2)), (f32, (k2,)),
        (f32, (k2 + k, 1)), (f32, (T, 4 * k + 2)),
    )
    if k < 2:
        raise ValueError(f"NCF needs k >= 2, got k = {k}")
    for name, x, (dtype, shape) in zip(_NAMES, args, want):
        if x.device != rel_x.device:
            raise ValueError(f"{name} is on {x.device}, rel_x on {rel_x.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_scores(rel_x, t, e, wv, tx, P_mlp, Q_mlp, P_gmf, Q_gmf, W1, b1, W2,
                 b2, W3, B) -> torch.Tensor:
    """(S,) NCF fused scores. CUDA tensors launch the kernel on the
    current stream (or raise); CPU tensors take the plain version."""
    args = (rel_x, t, e, wv, tx, P_mlp, Q_mlp, P_gmf, Q_gmf, W1, b1, W2, b2,
            W3, B)
    if rel_x.device.type == "cpu":
        return fused_scores_reference(*args)
    if rel_x.device.type != "cuda":
        raise ValueError(f"unsupported device {rel_x.device}")
    _check(*args)
    S, T, k, k2 = rel_x.shape[0], tx.shape[0], P_mlp.shape[1], W2.shape[1]
    out = torch.empty((S,), dtype=torch.float32, device=rel_x.device)
    if S == 0:
        return out
    # the kernel's per-query products [cU|rU|gU|cI|rI|gI] (csrc note)
    scratch = torch.empty((T, 6 * k), dtype=torch.float32,
                          device=rel_x.device)
    fn = common.load_function("ncf_scores", "fia_ncf_fused_scores", _ARGTYPES)
    with torch.cuda.device(rel_x.device):
        stream = torch.cuda.current_stream(rel_x.device).cuda_stream
        rc = fn(*(x.data_ptr() for x in args), out.data_ptr(),
                scratch.data_ptr(), S, T, k, k2, stream)
    if rc != 0:
        raise RuntimeError(f"ncf_scores kernel launch failed: cudaError {rc}")
    common.count_launch(sys.modules[__name__])
    return out
