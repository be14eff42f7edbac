"""Hessian-vector products (port of ``fia_tpu/influence/hvp.py``).

Forward-over-reverse ``jvp(grad(f))`` over the substituted block, as in
the reference: H v of the total loss (masked-mean squared error over the
related rows + L2), damping added after accumulation.
"""

from __future__ import annotations

import warnings

import torch

from fia_tpu_torch.influence import grads as G


def _block_total(model, params, u, i, x, y, w):
    """``(total, bvec0)``: the total block loss over rows (x, y, w) as a
    function of the flat block, and the current block."""
    return G.block_fn(model, params, u, i, lambda block: model.block_loss(
        params, block, u, i, x, y, w))


def make_block_hvp(model, params, u, i, x, y, w, damping: float):
    """``hvp(v) = H v + damping·v`` for the damped block Hessian of the
    total loss over rows (x, y, w); v is a flat (d,) vector. Composes
    with ``torch.func.vmap`` over queries."""
    total, bvec0 = _block_total(model, params, u, i, x, y, w)
    grad_fn = torch.func.grad(total)

    def hvp(v):
        return torch.func.jvp(grad_fn, (bvec0,), (v,))[1] + damping * v

    return hvp


def make_batched_block_hvp(model, params, u, i, x, y, w, damping: float,
                           linearize: bool = False):
    """:func:`make_block_hvp` for T queries at once: ``hvp(V)`` maps
    (T, d) to (T, d), query t's row through its own block Hessian over
    rows ``x[t], y[t], w[t]`` ((T, P, 2), (T, P), (T, P)).

    ``linearize=True`` traces the jvp of the vmapped block gradient once
    (``torch.func.linearize``) with the parts that do not depend on v
    folded to constants: every later call replays only the tangent's
    operations, the same forward-over-reverse products without the
    transforms' per-call work. For solvers that call the HVP thousands
    of times (LiSSA).
    """
    if not linearize:
        def one(uu, ii, xx, yy, ww, v):
            return make_block_hvp(model, params, uu, ii, xx, yy, ww,
                                  damping)(v)

        return lambda V: torch.func.vmap(one)(u, i, x, y, w, V)

    def grad_one(uu, ii, xx, yy, ww, bvec):
        total, _ = _block_total(model, params, uu, ii, xx, yy, ww)
        return torch.func.grad(total)(bvec)

    B0 = torch.func.vmap(lambda uu, ii: model.flatten_block(
        model.extract_block(params, uu, ii)))(u, i)
    with warnings.catch_warnings():
        # torch.fx's constant folding warns of the attributes it adds
        warnings.filterwarnings("ignore", message="Attempted to insert a "
                                "get_attr Node", category=UserWarning)
        _, jvp_fn = torch.func.linearize(
            lambda B: torch.func.vmap(grad_one)(u, i, x, y, w, B), B0)
    return lambda V: jvp_fn(V) + damping * V


def materialize_block_hessian(model, params, u, i, x, y, w, damping: float
                              ) -> torch.Tensor:
    """Dense damped block Hessian (d, d): the HVP vmapped over the
    identity."""
    hvp = make_block_hvp(model, params, u, i, x, y, w, damping)
    d = model.block_size
    return torch.func.vmap(hvp)(
        torch.eye(d, dtype=torch.float32, device=x.device))


def ravel_params(params) -> tuple[torch.Tensor, callable]:
    """``(flat, unravel)``: params flattened in sorted-key order, each
    leaf in row-major order (``jax.flatten_util.ravel_pytree``'s order on
    a dict), and the map back."""
    keys = sorted(params)
    shapes = [tuple(params[k].shape) for k in keys]
    sizes = [params[k].numel() for k in keys]
    flat = torch.cat([params[k].reshape(-1) for k in keys])

    def unravel(vec):
        parts = torch.split(vec, sizes)
        return {k: p.reshape(s) for k, p, s in zip(keys, parts, shapes)}

    return flat, unravel


def materialize_full_hessian(model, params, x, y, w=None,
                             damping: float = 0.0) -> torch.Tensor:
    """Dense Hessian of the total loss over ALL parameters, (D, D), rows
    and columns in :func:`ravel_params` order. For small D only."""
    flat0, unravel = ravel_params(params)
    Hmat = torch.func.hessian(
        lambda flat: model.loss(unravel(flat), x, y, w))(flat0)
    if damping:
        Hmat = Hmat + damping * torch.eye(flat0.shape[0], dtype=Hmat.dtype,
                                          device=Hmat.device)
    return Hmat


def make_full_hvp(model, params, x, y, w=None, damping: float = 0.0):
    """``hvp(v)`` over the full parameter dict; v is a dict like params."""
    grad_fn = torch.func.grad(lambda p: model.loss(p, x, y, w))

    def hvp(v):
        v = {k: v[k] for k in params}  # jvp pairs dicts by key order
        hv = torch.func.jvp(grad_fn, (params,), (v,))[1]
        if damping:
            hv = {k: hv[k] + damping * v[k] for k in hv}
        return hv

    return hvp
