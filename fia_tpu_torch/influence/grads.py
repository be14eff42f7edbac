"""Gradient primitives for influence analysis (port of
``fia_tpu/influence/grads.py:16-29``). Functions return *flattened*
block vectors (d = model.block_size)."""

from __future__ import annotations

import torch


def block_prediction_grad(model, params, u, i, x) -> torch.Tensor:
    """∇_block of the mean predicted rating over rows ``x`` — the FIA
    test-side vector v. Composes with ``torch.func.vmap`` over
    (u, i, x) for a batch of queries."""
    block0 = model.extract_block(params, u, i)

    def mean_pred(bvec):
        block = model.unflatten_block(bvec, block0)
        return torch.mean(model.block_predict(params, block, u, i, x))

    return torch.func.grad(mean_pred)(model.flatten_block(block0))
