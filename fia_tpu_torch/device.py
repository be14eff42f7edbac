"""Device selection and the float32 policy.

Entry points default to the CUDA device and raise without one: a run
meant for the card never carries on silently on the CPU. The CPU is an
explicit opt-in (``device="cpu"``), which the tests use.
"""

from __future__ import annotations

import torch


def set_fp32_policy() -> None:
    """Full float32 in every matrix product: TF32 keeps ~3 decimal
    digits, and the reference contracts the block Hessian at
    ``Precision.HIGHEST`` because rank correlation is the product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA request without a CUDA device
    raises. Also sets the float32 policy and, for the card, pins cuSOLVER
    as PyTorch's linear-algebra backend (process-wide): the default
    heuristic sends some batched LU solves to MAGMA, which cannot be
    captured in a CUDA graph (the flat program is one graph a geometry),
    while cuSOLVER's and cuBLAS's batched solves can, and replay bit for
    bit (checked on an H100)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    set_fp32_policy()
    if dev.type == "cuda":
        torch.backends.cuda.preferred_linalg_library("cusolver")
    return dev
