"""Sharded checkpoints: the counterpart of ``fia_tpu/train/checkpoint_orbax.py``
on ``torch.distributed.checkpoint`` (DCP), not orbax.

The same ``(params, opt_state, step)`` contract as the npz checkpoints of
``checkpoint.py`` and the reference's ``save`` / ``load`` / ``exists``, for
params that must restore with their placement intact: plain tensors, or
the :class:`~fia_tpu_torch.parallel.sharded.Placed` row shards of a
``('data', 'model')`` mesh (``shard_model_params``).

A checkpoint is a DCP directory. Each leaf is one key of a flat state
dict (``params/<name>``; a row-sharded table one key a shard,
``params/<name>/shard<k>of<K>``; ``opt_state/...``; ``step``). A process
saves and restores only the shards its own slots hold; shards that two
processes both hold are written once (DCP de-duplicates equal keys), and
a restore places each shard on its slot's device. Outside a process
group DCP runs in one process; inside the gloo group of
:mod:`fia_tpu_torch.parallel.distributed` ``save`` and ``load`` are
collective — every process calls them.

The template check (``_check_like``) holds the checkpoint's tree, leaf
shapes and dtypes to the template's and raises ``ValueError`` on any
difference. A checkpoint saved with ``opt_state`` restores without an
optimizer template (``opt_state`` None), and one saved without it
restores with one (``opt_state`` None), as the reference's does.
"""

from __future__ import annotations

import os
import warnings
from contextlib import contextmanager

import torch

from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.parallel.sharded import Placed

_STEP = "step"


def _in_group() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


@contextmanager
def _as_intended():
    """DCP warns, on every call, that outside a process group it runs in
    one process and that a save replaces an existing checkpoint: both
    are this module's contract (the reference saves with ``force``)."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="torch.distributed is disabled")
        warnings.filterwarnings(
            "ignore", message="Detected an existing checkpoint")
        yield


def _items(tree, prefix: str):
    """``(key, global_shape, local)`` of every leaf of ``tree`` in a fixed
    order: ``local`` lists ``(slot position, tensor)`` for this process's
    holdings (one entry, position None, for a plain tensor)."""
    if isinstance(tree, Placed):
        if tree.axis is None:
            mine = [(j, x) for j, x in enumerate(tree.shards)
                    if x is not None]
            yield prefix, tuple(tree.shape), mine[:1]
            return
        parts = int(tree.mesh.shape[tree.axis])
        rows = int(tree.shape[0]) // parts
        coords = pmesh.axis_coords(tree.mesh, tree.axis)
        for k in range(parts):
            mine = [(j, x) for j, (c, x) in enumerate(zip(coords,
                                                          tree.shards))
                    if c == k and x is not None]
            yield (f"{prefix}/shard{k}of{parts}",
                   (rows, *tuple(tree.shape[1:])), mine[:1])
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}/{k}")
        return
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        for name, v in zip(names, tree):
            yield from _items(v, f"{prefix}/{name}")
        return
    t = torch.as_tensor(tree)
    yield prefix, tuple(t.shape), [(None, t)]


def save(path: str, params, opt_state=None, step: int = 0) -> str:
    """Write ``params`` (and ``opt_state``) at ``step`` to the directory
    ``path``, over an existing checkpoint there; returns the absolute
    path. Collective inside a process group."""
    path = os.path.abspath(path)
    sd = {_STEP: torch.tensor(int(step), dtype=torch.int64)}
    trees = [("params", params)]
    if opt_state is not None:
        trees.append(("opt_state", opt_state))
    for prefix, tree in trees:
        for key, _, local in _items(tree, prefix):
            if local:
                sd[key] = local[0][1].detach().cpu()
    dcp = _dcp()
    with _as_intended():
        dcp.save(sd, storage_writer=dcp.FileSystemWriter(path, overwrite=True),
                 no_dist=not _in_group())
    return path


def _saved(path: str) -> dict:
    """``{key: (shape, dtype)}`` of every leaf the checkpoint holds."""
    md = _dcp().FileSystemReader(path).read_metadata()
    return {k: (tuple(v.size), v.properties.dtype)
            for k, v in md.state_dict_metadata.items()}


def _check_like(template, got: dict, prefix: str = "params") -> None:
    """Raise ``ValueError`` if the saved leaves under ``prefix`` (``got``,
    ``{key: (shape, dtype)}``) don't match the template's tree, shapes
    and dtypes — a restore must not accept a mismatched checkpoint."""
    want = list(_items(template, prefix))
    tkeys = sorted(k for k, _, _ in want)
    gkeys = sorted(k for k in got
                   if k == prefix or k.startswith(prefix + "/"))
    if tkeys != gkeys:
        raise ValueError(f"checkpoint {prefix} tree {gkeys} != template "
                         f"{tkeys}")
    for key, shape, local in want:
        gs, gd = got[key]
        if tuple(gs) != tuple(shape):
            raise ValueError(f"checkpoint leaf {key} shape {tuple(gs)} != "
                             f"template {tuple(shape)}")
        if local and local[0][1].dtype != gd:
            raise ValueError(f"checkpoint leaf {key} dtype {gd} != "
                             f"template {local[0][1].dtype}")


def _rebuild(template, prefix: str, got: dict):
    """``template``'s structure filled from ``got`` (``{key: host
    tensor}``), each tensor on the device of the leaf it replaces."""
    if isinstance(template, Placed):
        coords = (pmesh.axis_coords(template.mesh, template.axis)
                  if template.axis is not None else None)
        parts = (int(template.mesh.shape[template.axis])
                 if template.axis is not None else 1)
        shards, placed = [], {}
        for j, (slot, old) in enumerate(zip(template.mesh.devices.flat,
                                            template.shards)):
            if old is None:
                shards.append(None)
                continue
            key = (prefix if coords is None
                   else f"{prefix}/shard{coords[j]}of{parts}")
            if (slot.device, key) not in placed:
                placed[(slot.device, key)] = got[key].to(slot.device)
            shards.append(placed[(slot.device, key)])
        return Placed(template.mesh, shards, template.axis,
                      tuple(template.shape))
    if isinstance(template, dict):
        return {k: _rebuild(template[k], f"{prefix}/{k}", got)
                for k in template}
    if isinstance(template, tuple):
        names = getattr(template, "_fields", range(len(template)))
        vals = [_rebuild(v, f"{prefix}/{n}", got)
                for n, v in zip(names, template)]
        return (type(template)(*vals) if hasattr(template, "_fields")
                else type(template)(vals))
    dev = template.device if torch.is_tensor(template) else "cpu"
    return got[prefix].to(dev)


def load(path: str, params_template, opt_template=None):
    """``(params, opt_state, step)`` from the checkpoint at ``path``,
    shaped and placed like the templates (``opt_state`` None without an
    optimizer template, or when none was saved). Collective inside a
    process group."""
    path = os.path.abspath(path)
    saved = _saved(path)
    _check_like(params_template, saved, "params")
    trees = [("params", params_template)]
    if opt_template is not None and any(
            k.startswith("opt_state/") for k in saved):
        _check_like(opt_template, saved, "opt_state")
        trees.append(("opt_state", opt_template))
    target = {_STEP: torch.zeros((), dtype=torch.int64)}
    for prefix, tree in trees:
        for key, shape, local in _items(tree, prefix):
            if local:
                target[key] = torch.empty(shape, dtype=local[0][1].dtype)
    with _as_intended():
        _dcp().load(target, checkpoint_id=path, no_dist=not _in_group())
    params = _rebuild(params_template, "params", target)
    opt = (_rebuild(opt_template, "opt_state", target)
           if len(trees) > 1 else None)
    return params, opt, int(target[_STEP])


def exists(path: str) -> bool:
    return os.path.isdir(os.path.abspath(path))
