"""Model interface for latent-factor recommenders (port of
``fia_tpu/models/base.py``).

A model is a small object exposing plain functions over a parameter
dict ``dict[str, Tensor]``:

  - ``init_params(generator, device)`` -> params
  - ``predict(params, x)``             -> (B,) predicted ratings
  - ``loss(params, x, y, w)``          -> scalar total loss (masked-mean
    squared error + L2)
  - ``extract_block`` / ``flatten_block`` / ``unflatten_block`` -> the
    FIA (user, item) parameter sub-block, flattened in ``block_keys``
    order so the iHVP layout matches the reference.

Initialisation draws from an explicit ``torch.Generator``, which cannot
reproduce ``jax.random``; parity runs carry the reference's params
across with :func:`params_from_numpy`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Params = dict  # name -> torch.Tensor
Block = dict  # name -> torch.Tensor (the FIA sub-block)


def truncated_normal(generator: torch.Generator, shape, stddev: float,
                     device=None) -> torch.Tensor:
    """TF-style truncated normal (resampled beyond 2 sigma). Drawn on
    the generator's device (the CPU for a default generator) and then
    moved, so the values do not depend on the target device."""
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (stddev * out).to(device or generator.device)


def _weighted_mean(err: torch.Tensor, w) -> torch.Tensor:
    """Plain mean, or the masked mean sum(w·err)/max(sum(w), 1) when
    ``w`` is given (padded callers mask rows out)."""
    if w is None:
        return torch.mean(err)
    w = w.to(err.dtype)
    return torch.sum(w * err) / torch.clamp(torch.sum(w), min=1.0)


class LatentFactorModel:
    """Base class; subclasses define the forward pass and the FIA block."""

    #: params that carry L2 weight decay (wd * 0.5 * sum(w^2)).
    decayed: tuple[str, ...] = ()

    #: flattening order of the FIA block (the reference's params_test
    #: order, e.g. [p_u, q_i, b_u, b_i] for MF).
    block_keys: tuple[str, ...] = ()

    #: names the hand-written score kernel of this block geometry
    #: (influence/kernels/); None when the model has none.
    kernel_family: str | None = None

    #: ``kernel_operands(params)``: the score kernel's table and weight
    #: operands, in the order its wrapper takes them.
    kernel_operands = None

    #: Gauss-Newton hooks of the flat query path (see the reference's
    #: models/base.py): the block Hessian over rows (x, y, w) is
    #:   H = (2/n) Σ_j w_j (g_j g_jᵀ + a_j b_j e_j · C) + diag(r)
    #: with g_j = ``block_row_grads``, C = ``block_cross_const`` and
    #: r = ``block_reg_diag``.
    block_row_grads = None
    block_cross_const = None
    block_reg_diag = None

    #: optional closed-form block Hessian
    #: ``block_hessian(params, u, i, x, y, w) -> (d, d)`` (undamped); the
    #: padded engine uses it in place of ``block_size`` autodiff HVPs.
    block_hessian = None

    def __init__(self, num_users: int, num_items: int, embedding_size: int,
                 weight_decay: float):
        self.num_users = int(num_users)
        self.num_items = int(num_items)
        self.embedding_size = int(embedding_size)
        self.weight_decay = float(weight_decay)

    # -- subclass hooks ----------------------------------------------------
    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        raise NotImplementedError

    def init_params(self, generator: torch.Generator, device=None) -> Params:
        raise NotImplementedError

    def predict(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 2) int (user, item) -> (B,) float ratings."""
        raise NotImplementedError

    def row_predict(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """``predict``, with each row's bits independent of how many rows
        ``x`` has (the flat path's residuals; on the card a library kernel
        chosen by the row count can change them)."""
        return self.predict(params, x)

    def extract_block(self, params: Params, u, i) -> Block:
        raise NotImplementedError

    def with_block(self, params: Params, block: Block, u, i) -> Params:
        """params with the (u, i) block written back, out of place."""
        raise NotImplementedError

    @property
    def block_size(self) -> int:
        raise NotImplementedError

    # -- generic functions -------------------------------------------------
    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.param_shapes().values())

    def reg_loss(self, params: Params) -> torch.Tensor:
        reg = torch.zeros((), dtype=torch.float32,
                          device=next(iter(params.values())).device)
        for name in self.decayed:
            reg = reg + 0.5 * torch.sum(torch.square(params[name]))
        return self.weight_decay * reg

    def indiv_loss_from_pred(self, pred: torch.Tensor, y) -> torch.Tensor:
        """Per-example loss given predictions, (B,): the one hook both
        the training loss and the block influence loss route through."""
        return torch.square(pred - y)

    def indiv_loss(self, params: Params, x, y) -> torch.Tensor:
        return self.indiv_loss_from_pred(self.predict(params, x), y)

    def loss(self, params: Params, x, y, w=None) -> torch.Tensor:
        """(Weighted-)mean squared error + L2; with ``w`` the mean is
        sum(w·err)/sum(w)."""
        return _weighted_mean(self.indiv_loss(params, x, y), w) + \
            self.reg_loss(params)

    def loss_no_reg(self, params: Params, x, y, w=None) -> torch.Tensor:
        return _weighted_mean(self.indiv_loss(params, x, y), w)

    def mae(self, params: Params, x, y) -> torch.Tensor:
        return torch.mean(torch.abs(self.predict(params, x) - y))

    def adversarial_loss(self, params: Params, x, y):
        """Adversarial-loss hook, ``(None, None)`` for rating regression
        (the reference's ``LatentFactorModel.adversarial_loss``: the
        original FIA code's MF and NCF disable their classification
        log(1 - p) loss the same way). A classification model family can
        override it."""
        return None, None

    def block_predict(self, params: Params, block: Block, u, i, x):
        """Predict rows ``x`` with the (u, i) block substituted."""
        return self.predict(self.with_block(params, block, u, i), x)

    def block_reg(self, params: Params, block: Block, u, i) -> torch.Tensor:
        """L2 regulariser with the (u, i) block substituted. Subclasses
        override with the scatter-free form ``reg(params) + wd/2 ·
        (‖block rows‖² − ‖table rows‖²)``."""
        return self.reg_loss(self.with_block(params, block, u, i))

    def block_loss(self, params: Params, block: Block, u, i, x, y, w=None):
        """Total loss over rows (x, y, w) with the block substituted."""
        err = self.indiv_loss_from_pred(
            self.block_predict(params, block, u, i, x), y
        )
        return _weighted_mean(err, w) + self.block_reg(params, block, u, i)

    def flatten_block(self, block: Block) -> torch.Tensor:
        keys = self.block_keys or tuple(sorted(block))
        return torch.cat([torch.reshape(block[k], (-1,)) for k in keys])

    def unflatten_block(self, vec: torch.Tensor, like: Block) -> Block:
        keys = self.block_keys or tuple(sorted(like))
        out, pos = {}, 0
        for k in keys:
            shape = tuple(like[k].shape)
            n = math.prod(shape)
            out[k] = torch.reshape(vec[pos : pos + n], shape)
            pos += n
        return out


def params_from_numpy(model: LatentFactorModel, arrays, device) -> Params:
    """Carry params across as float32 tensors on ``device`` — e.g. the
    reference's ``jax.tree_util.tree_map(np.asarray, params)``. Names
    and shapes must be exactly the model's."""
    want = model.param_shapes()
    if set(arrays) != set(want):
        raise ValueError(
            f"param names {sorted(arrays)} != {sorted(want)} for "
            f"{type(model).__name__}"
        )
    out = {}
    for name, shape in want.items():
        a = np.asarray(arrays[name], dtype=np.float32)
        if a.shape != shape:
            raise ValueError(f"param {name!r}: shape {a.shape} != {shape}")
        out[name] = torch.tensor(a, device=device)  # a copy
    return out
