"""Score kernels for the flat influence path (port of
``fia_tpu/influence/kernels/__init__.py``), and the launch counts of
every hand-written kernel of the port.

The score stage computes, for every flat related row s owned by query t,

    score_s = wv_s * (2 e_s (g_s · ihvp_t) + reg_dot_t) / n_t

with g_s the row's closed-form block gradient. Two variants:

  - ``cuda``: the hand-written CUDA kernel of the model's block geometry
    (``kernel_family``: ``kernels/mf.py`` + ``csrc/mf_scores.cu``,
    ``kernels/ncf.py`` + ``csrc/ncf_scores.cu``), which re-forms g_s from
    the embedding tables (and, for NCF, the MLP weights) on chip, so
    neither the (S, d) gradient matrix nor the (S, d) iHVP expansion
    reaches device memory;
  - ``torch``: the kernel's plain PyTorch version, the same function in
    tensor ops — the CPU path and the kernel's parity anchor.
"""

from __future__ import annotations

import torch

from fia_tpu_torch.influence.grads import autodiff_row_grads  # noqa: F401
from fia_tpu_torch.influence.kernels import certificate as _certificate
from fia_tpu_torch.influence.kernels import eigmin as _eigmin
from fia_tpu_torch.influence.kernels import mf as _mf
from fia_tpu_torch.influence.kernels import ncf as _ncf
from fia_tpu_torch.influence.kernels import segment as _segment

VARIANTS = ("cuda", "torch")
#: every module holding a hand-written kernel, with its launch counts
KERNEL_MODULES = (_mf, _ncf, _segment, _certificate, _eigmin)

#: kernel_family -> the module of its CUDA kernel and plain version
_CUDA_FAMILIES = {"mf": _mf, "ncf": _ncf}


def supports_cuda(model) -> bool:
    """A CUDA score kernel exists for this model's block geometry."""
    return getattr(model, "kernel_family", None) in _CUDA_FAMILIES


def resolve_variant(requested: str, model, device) -> str:
    """Resolve an engine-level ``kernel`` request to a variant.

    ``auto`` is ``cuda`` on a CUDA device and ``torch`` on the CPU.
    Requests that cannot be served raise: ``cuda`` on the CPU, and any
    model without a CUDA kernel on a CUDA device (the card never runs
    the plain score stage unless asked to by name).
    """
    device = torch.device(device)
    if requested == "auto":
        requested = "cuda" if device.type == "cuda" else "torch"
    if requested not in VARIANTS:
        raise ValueError(f"unknown kernel variant {requested!r}")
    if requested == "cuda":
        if device.type != "cuda":
            raise ValueError(f"kernel='cuda' needs a CUDA device, not {device}")
        if not supports_cuda(model):
            raise NotImplementedError(_no_kernel(model))
    return requested


def _no_kernel(model) -> str:
    return (f"{type(model).__name__} has no score kernel: its kernel_family "
            f"{getattr(model, 'kernel_family', None)!r} is none of "
            f"{tuple(_CUDA_FAMILIES)}")


def row_grads(model, params, ut, it, rel_x) -> torch.Tensor:
    """(S, d) per-row block gradients for the Hessian and grads stages
    (the model's closed-form ``block_row_grads`` hook)."""
    return model.block_row_grads(params, ut, it, rel_x)


def fused_scores(model, variant: str, params, tx, t, rel_x, e, wv, B):
    """The score stage: (S,) influence scores for the flat rows.

    ``tx`` (T, 2) are the query pairs, ``t`` the rows' segment ids,
    ``rel_x`` their own (user, item), ``e``/``wv`` residuals and
    validity, ``B`` the (T, d + 2) ``[ihvp | reg_dot | n_t]`` pack
    (:func:`common.query_matrix`). The model's ``kernel_operands``
    hook supplies the tables and weights between ``tx`` and ``B``.
    """
    if not supports_cuda(model):
        raise NotImplementedError(_no_kernel(model))
    impl = _CUDA_FAMILIES[model.kernel_family]
    args = (rel_x, t, e, wv, tx, *model.kernel_operands(params), B)
    if variant == "cuda":
        if rel_x.device.type != "cuda":
            raise ValueError(
                f"variant 'cuda' asked for with tensors on {rel_x.device}"
            )
        return impl.fused_scores(*args)
    if variant == "torch":
        return impl.fused_scores_reference(*args)
    raise ValueError(f"unknown kernel variant {variant!r}")


def captured_counts() -> tuple[int, ...]:
    """``captured`` of each of :data:`KERNEL_MODULES`."""
    return tuple(m.captured for m in KERNEL_MODULES)


def count_replay(held) -> None:
    """A graph holding ``held`` launches of each of
    :data:`KERNEL_MODULES` was replayed."""
    for m, n in zip(KERNEL_MODULES, held):
        m.launches += n
