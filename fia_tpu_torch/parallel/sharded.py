"""Row-sharded embedding tables on a ``('data', 'model')`` mesh (port of
``fia_tpu/parallel/sharded.py``).

The scaling axes of this workload are #users/#items (embedding-table
rows) and #queries/#train-rows (data); there is no sequence dimension.
For configurations whose tables exceed one device's memory, the tables
are row-sharded over a ``model`` mesh axis while queries shard over
``data``: each ``data`` row of the mesh holds one copy of every table,
split into contiguous row shards over its ``model`` slots, and every
other param is replicated once per physical device.

A sharded engine (``InfluenceEngine(shard_tables=True)``) gathers, once
a dispatch and shard, the table rows the shard's queries need through
:func:`gather_table_rows` (a masked local gather on each ``model`` slot,
the partials added in slot order on the shard's device), then runs the
unchanged single-device program on those shard-local tables with the ids
remapped into them (:func:`sorted_keys`, :func:`remap`), so the score
kernels still launch and the result is the replicated program's bits
(docs/design.md §20).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fia_tpu_torch import obs
from fia_tpu_torch.parallel import mesh as pmesh

#: param names holding per-user/per-item rows, per model class name
TABLE_PARAMS = {
    "MF": ("P", "Q", "bu", "bi"),
    "NCF": ("P_mlp", "Q_mlp", "P_gmf", "Q_gmf"),
}

#: which id axis indexes each table's rows, aligned with TABLE_PARAMS
TABLE_ROW_AXES = {
    "MF": ("user", "item", "user", "item"),
    "NCF": ("user", "item", "user", "item"),
}


def table_names(model) -> tuple[str, ...]:
    return TABLE_PARAMS.get(type(model).__name__, ())


def padded_rows(n: int, parts: int) -> int:
    """Smallest multiple of ``parts`` >= ``n``: the row count of a table
    row-sharded over ``parts`` slots (equal shards)."""
    return -(-int(n) // int(parts)) * int(parts)


def make_2d_mesh(n_devices: int | None = None, model_parallel: int = 2,
                 device=None) -> pmesh.Mesh:
    """``('data', 'model')`` mesh over the first ``n_devices`` local
    slots (:func:`~fia_tpu_torch.parallel.mesh.make_mesh`, virtual slots
    included). ``model_parallel`` must divide the slot count: raises
    rather than silently unsharding the tables (a configuration that
    asked for sharding because the tables exceed one device must not fall
    back to full replication)."""
    flat = pmesh.make_mesh(n_devices, device=device)
    n = int(flat.devices.size)
    if n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide the device "
            f"count {n}")
    mp = int(model_parallel)
    return pmesh.Mesh(flat.devices.reshape(n // mp, mp), ("data", "model"))


def _model_rows(mesh: pmesh.Mesh, axis: str) -> np.ndarray:
    """(rows, size) flat slot positions: each row the slots of one mesh
    row along ``axis``, in ``axis`` order (row r serves data shard r)."""
    ax = mesh.axis_names.index(axis)
    pos = np.arange(int(mesh.devices.size)).reshape(mesh.devices.shape)
    return np.moveaxis(pos, ax, -1).reshape(-1, int(mesh.shape[axis]))


@dataclass
class Placed:
    """One param placed on a mesh: ``shards[j]`` is the tensor slot j of
    ``mesh.devices.flat`` holds (``None`` for another process's slot;
    slots on one device holding the same rows share one tensor).
    ``axis`` is the mesh axis dim 0 is split along, ``None`` for a
    replica; ``shape`` the whole (padded) shape."""

    mesh: pmesh.Mesh
    shards: list
    axis: str | None
    shape: tuple

    @property
    def rows_local(self) -> int:
        return self.shape[0] // int(self.mesh.shape[self.axis])

    def row_shards(self) -> list:
        """The row shards of this process's first mesh row, in order:
        together, one whole (padded) table."""
        for row in _model_rows(self.mesh, self.axis):
            got = [self.shards[j] for j in row]
            if all(x is not None for x in got):
                return got
        raise KeyError("this process holds no whole row of shards")

    def on(self, device) -> torch.Tensor:
        """The replica on ``device`` (``axis`` None)."""
        for s, x in zip(self.mesh.devices.flat, self.shards):
            if x is not None and s.device == device:
                return x
        raise KeyError(f"no replica on {device}")


def shard_model_params(mesh: pmesh.Mesh, params, model, axis: str = "model",
                       pad_rows: bool = True) -> dict:
    """Row-shard the embedding tables over ``axis``; replicate the rest.

    Each table's rows are zero-padded to a :func:`padded_rows` multiple
    (``pad_rows``; off only for divisible-by-construction configurations)
    and split into contiguous shards, shard k on the k-th ``axis`` slot of
    every mesh row. Real ids never reach the pad rows (they lie past
    ``num_users``/``num_items``). Everything else is replicated once per
    physical device. Placement goes through
    :func:`~fia_tpu_torch.parallel.distributed.put_global` (each process
    places only its own slots). Returns ``{name: Placed}``."""
    from fia_tpu_torch.parallel.distributed import put_global

    names = table_names(model)
    parts = int(mesh.shape[axis])
    out = {}
    with obs.span("parallel.shard_params", tables=len(names),
                  parts=parts) as sp:
        for k, v in params.items():
            v = torch.as_tensor(v)
            if k in names:
                if pad_rows:
                    pr = padded_rows(v.shape[0], parts)
                    if pr != int(v.shape[0]):
                        v = torch.cat([v, v.new_zeros(
                            (pr - int(v.shape[0]), *v.shape[1:]))])
                elif v.shape[0] % parts:
                    raise ValueError(
                        f"table {k} has {v.shape[0]} rows, not a multiple "
                        f"of {parts}: place it with pad_rows=True")
                out[k] = Placed(mesh, put_global(mesh, v, axis), axis,
                                tuple(v.shape))
            else:
                out[k] = Placed(mesh, put_global(mesh, v), None,
                                tuple(v.shape))
        per_dev = per_device_table_bytes(out, model)
        obs.REGISTRY.gauge("parallel.table_bytes_per_device").set(per_dev)
        for k in names:
            if k in out:
                obs.REGISTRY.gauge("parallel.table_bytes", table=k).set(
                    int(np.prod(out[k].shape))
                    * torch.as_tensor(params[k]).element_size())
        sp.set(per_device_bytes=per_dev)
    return out


def whole_params(params, model) -> dict:
    """Whole tensors from placed params (a sharded engine's ``params``,
    or a sharded checkpoint restored): each row-sharded table's shards
    concatenated in row order with the zero pad rows cut, a replica as
    it is, a plain tensor unchanged — what an engine is built from. Needs
    a whole mesh row of shards in this process (``Placed.row_shards``)."""
    shapes = model.param_shapes()
    out = {}
    for k, v in params.items():
        if isinstance(v, Placed) and v.axis is not None:
            v = torch.cat(v.row_shards())[: shapes[k][0]]
        elif isinstance(v, Placed):
            v = next(x for x in v.shards if x is not None)
        out[k] = v
    return out


def gather_table_rows(mesh: pmesh.Mesh, model, params, uids, iids,
                      axis: str = "model") -> list:
    """Table rows of the ids of each ``data`` shard, from row-sharded
    tables.

    ``uids``/``iids`` hold one int tensor of ids per ``data`` shard
    (aligned with :func:`~fia_tpu_torch.parallel.mesh.data_slots`;
    ``None`` for a shard of another process). Returns, per shard,
    ``{table_name: rows}`` on the shard's device (``None`` where the ids
    were).

    On each ``model`` slot k of the shard's mesh row, a masked local
    gather: ``loc = id - k * rows_local``, clamped, and ``torch.where``
    keeping the row where ``loc`` is in range and an exact +0.0 elsewhere
    (never a mask multiply, so no -0.0 from ``0 * x``); the partials move
    to the shard's device and add in slot order. Exactly one term of each
    sum is the row, so the result is the replicated gather's bits
    (``x + 0.0 == x`` for every x but -0.0, which trained rows never
    hold). The tables stay where they are: only the gathered rows
    travel."""
    names = table_names(model)
    row_axes = TABLE_ROW_AXES[type(model).__name__]
    obs.REGISTRY.counter("parallel.gathers_total").inc()
    obs.TRACER.current_span().event("parallel.gather_table_rows",
                                    tables=len(names))
    rows = _model_rows(mesh, axis)
    out = []
    for r, (u, i) in enumerate(zip(uids, iids)):
        if u is None:
            out.append(None)
            continue
        home = u.device
        got = {}
        for name, rax in zip(names, row_axes):
            tab = params[name]
            rl = tab.rows_local
            ids = u if rax == "user" else i
            acc = None
            for k, j in enumerate(rows[r]):
                tl = tab.shards[j]
                loc = ids.to(tl.device) - k * rl
                ok = (loc >= 0) & (loc < rl)
                part = tl[loc.clamp(0, rl - 1).long()]
                part = torch.where(ok.reshape(ok.shape + (1,) * (tl.ndim - 1)),
                                   part, 0.0).to(home)
                acc = part if acc is None else acc + part
            got[name] = acc
        out.append(got)
    return out


def sorted_keys(uids: torch.Tensor, iids: torch.Tensor):
    """The sorted user and item ids of a shard (duplicates kept): the
    row order of its shard-local tables."""
    return torch.sort(uids).values, torch.sort(iids).values


def remap(keys: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Each id's position in the shard-local table: the first position
    of its value in ``keys`` (sorted). Equal ids map to one position and
    distinct ids to distinct ones, so every id comparison keeps its
    truth, and ``local[remap(keys, x)] == table[x]`` for every id of the
    shard. Static shapes, no host wait (capturable); clamped into the
    table, which only an id absent from ``keys`` (the zeroed inputs of a
    graph's warm-up) can need."""
    pos = torch.searchsorted(keys, ids.to(keys.dtype).contiguous(),
                             out_int32=keys.dtype == torch.int32)
    return pos.clamp_(max=keys.shape[0] - 1).to(ids.dtype)


def per_device_table_bytes(params, model) -> int:
    """Max bytes of table rows any single slot holds, counted per slot
    id: ``padded_rows / model`` of each table when row-sharded, the whole
    tables when replicated (a plain tensor counts as slot 0's)."""
    per_dev: dict = {}
    for name in table_names(model):
        v = params.get(name)
        if v is None:
            continue
        if isinstance(v, Placed):
            for s, x in zip(v.mesh.devices.flat, v.shards):
                if x is not None:
                    per_dev[int(s.id)] = (per_dev.get(int(s.id), 0)
                                          + x.numel() * x.element_size())
        else:
            x = torch.as_tensor(v)
            per_dev[0] = per_dev.get(0, 0) + x.numel() * x.element_size()
    return max(per_dev.values(), default=0)


def replicate_rest(mesh: pmesh.Mesh, tree) -> list:
    """``tree`` replicated on this process's slots (one copy a physical
    device): one tree per slot, aligned with ``mesh.devices.flat``."""
    from fia_tpu_torch.parallel.distributed import put_global

    return put_global(mesh, tree)
