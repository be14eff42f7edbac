"""Gradient primitives for influence analysis (port of
``fia_tpu/influence/grads.py``). The block functions return *flattened*
block vectors (d = model.block_size), each composing with
``torch.func.vmap`` over a batch of queries; the full-parameter ones
return dicts of tensors shaped like the params."""

from __future__ import annotations

import torch


def block_fn(model, params, u, i, fn):
    """``(f, bvec0)``: ``f(bvec)`` runs ``fn(block)`` on the unflattened
    block vector, and ``bvec0`` is the current (u, i) block, flat."""
    block0 = model.extract_block(params, u, i)

    def f(bvec):
        return fn(model.unflatten_block(bvec, block0))

    return f, model.flatten_block(block0)


def block_prediction_grad(model, params, u, i, x) -> torch.Tensor:
    """∇_block of the mean predicted rating over rows ``x`` — the FIA
    test-side vector v."""
    f, bvec0 = block_fn(model, params, u, i, lambda block: torch.mean(
        model.block_predict(params, block, u, i, x)))
    return torch.func.grad(f)(bvec0)


def block_loss_grad(model, params, u, i, x, y, w=None) -> torch.Tensor:
    """∇_block of the total loss ((masked-)mean MSE + L2) over rows x."""
    f, bvec0 = block_fn(model, params, u, i, lambda block: model.block_loss(
        params, block, u, i, x, y, w))
    return torch.func.grad(f)(bvec0)


def per_example_block_loss_grads(model, params, u, i, x, y) -> torch.Tensor:
    """(B, d): ∇_block L(z_j) for each row j fed alone. Each row's loss is
    its own squared error plus the *full* regulariser, so every row's
    gradient carries the same wd·θ_block term (the reference's per-row
    feeds, ``matrix_factorization.py:240-246``)."""
    def one(xj, yj):
        f, bvec0 = block_fn(model, params, u, i, lambda block:
                            model.block_loss(params, block, u, i,
                                             xj[None, :], yj[None]))
        return torch.func.grad(f)(bvec0)

    return torch.func.vmap(one)(x, y)


def autodiff_row_grads(model, params, u, i, x) -> torch.Tensor:
    """(B, d) per-row block Jacobian by vmapped single-row autodiff: the
    definition every closed-form ``block_row_grads`` is held against.
    ``u``/``i`` may be scalars or (B,) per-row query ids."""

    def one(xj, uu, ii):
        f, bvec0 = block_fn(model, params, uu, ii, lambda block:
                             model.block_predict(params, block, uu, ii,
                                                 xj[None, :])[0])
        return torch.func.grad(f)(bvec0)

    if torch.as_tensor(u).ndim > 0:
        return torch.func.vmap(one)(x, u, i)
    return torch.func.vmap(lambda xj: one(xj, u, i))(x)


def per_example_block_prediction_grads(model, params, u, i, x
                                       ) -> torch.Tensor:
    """(B, d): g_j = ∇_block r̂(z_j), the J of the Gauss-Newton block
    Hessian. The model's closed-form ``block_row_grads`` when it has
    one, else :func:`autodiff_row_grads`."""
    if model.block_row_grads is not None:
        return model.block_row_grads(params, u, i, x)
    return autodiff_row_grads(model, params, u, i, x)


def per_example_full_loss_grads(model, params, x, y) -> dict:
    """Per-example full-parameter loss gradients: a dict of the params'
    names to (B, ...) stacks, row j the gradient of row j's loss fed
    alone (its squared error plus the full regulariser)."""

    def one(xj, yj):
        return torch.func.grad(
            lambda p: model.loss(p, xj[None, :], yj[None]))(params)

    return torch.func.vmap(one)(torch.as_tensor(x), torch.as_tensor(y))


def full_loss_grad(model, params, x, y, w=None) -> dict:
    """∇_params of the total loss ((masked-)mean MSE + L2) over rows x."""
    return torch.func.grad(lambda p: model.loss(p, x, y, w))(params)


def full_loss_no_reg_grad(model, params, x, y, w=None) -> dict:
    """∇_params of the (masked-)mean MSE over rows x, no regulariser."""
    return torch.func.grad(lambda p: model.loss_no_reg(p, x, y, w))(params)
