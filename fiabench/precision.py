"""The arithmetic the plain reference runs in.

``float64``: the reference itself, every operand float64. ``tf32``: its
control, one precision below what the configurations state (float32 with
TF32 off): float32 operands, each matrix product and dot taking its
inputs rounded to TF32's 10-bit mantissa and summing in float32, as the
card's TF32 tensor cores do. The rounding is done by hand, so the control
reads the same on the CPU and on the card.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32")


def dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties away from 0):
    the low 13 of the 23 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _in(x: torch.Tensor, precision: str) -> torch.Tensor:
    return round_tf32(x) if precision == "tf32" else x


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` (batched as ``torch.matmul``) at ``precision``."""
    return torch.matmul(_in(a, precision), _in(b, precision))


def rowdot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """Row-wise dot products ``(a * b).sum(-1)`` at ``precision``."""
    return torch.sum(_in(a, precision) * _in(b, precision), dim=-1)
