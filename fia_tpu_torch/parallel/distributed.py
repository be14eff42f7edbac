"""Multi-process runtime (port of ``fia_tpu/parallel/distributed.py``) on
``torch.distributed``.

The reference joins its processes into one JAX runtime and lets XLA
insert the collectives. The port's processes join one
``torch.distributed`` group instead, over **gloo**, on the CPU and on the
card alike: two processes that share one card cannot form an NCCL group,
and every exchange of this module ends on the host anyway (the
reference's ``process_allgather`` fetches too). Each exchange is an
all-gather of host objects followed by a sum or a stitch in GLOBAL slot
order, never an all-reduce (whose order is the library's), so a mesh of
N slots over several processes gives the bits of the one-process mesh of
the same N slots.

  - :func:`initialize` — join the group (``tcp://<coordinator>``),
    idempotent, a no-op with no coordinator, the process's CUDA slots
    over ``local_device_ids`` where given; :func:`shutdown` leaves it.
  - :func:`runtime_info` — process and slot topology.
  - :func:`make_hybrid_mesh` — a ``('data', 'model')`` mesh whose
    ``model`` axis (the table-row gathers of every query) stays within a
    process while ``data`` spans processes.
  - :func:`process_local_rows` / :func:`global_batch` — which rows of a
    global batch this process feeds, and those rows as the shards its
    slots take.
  - :func:`put_global` — host arrays (the same on every process) placed
    on this process's slots.
  - :func:`allgather_object` / :func:`gather_shards` — the exchanges;
    :func:`fill_shards` — a slot-ordered list of this process's results
    completed with every other process's.

Nothing falls back silently: a failed group init or exchange raises
:class:`~fia_tpu_torch.reliability.taxonomy.HostLost` (classified
``host_lost``), chained to the library's error.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np
import torch

from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.reliability import inject, sites, taxonomy
from fia_tpu_torch.reliability import policy as rpolicy

# Per-array placement retry (see put_global): short delays — the engine's
# _reset_device_state already waited out the worker-restart window, this
# only covers the residual race at placement time.
_PUT_RETRY = rpolicy.RetryPolicy(
    max_attempts=3, base_delay=0.1, max_delay=1.0, jitter=0.25
)
#: how long a process waits for its peers at init and in an exchange
TIMEOUT_S = 300.0

_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Join the multi-process group: ``init_process_group("gloo",
    init_method="tcp://<coordinator_address>", world_size=num_processes,
    rank=process_id)``; a process lays its slots over every CUDA device
    it sees, or over ``local_device_ids`` only (CUDA ordinals, in the
    order given: a process of a host with several cards keeps to its
    own), or over its armed virtual slots (on the first of those
    ordinals).

    With no coordinator and no process count this is a no-op, so drivers
    can call it unconditionally; repeated calls are no-ops. A failed
    join raises ``HostLost``."""
    global _initialized
    if _initialized:
        return
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id together")
    pmesh.set_local_device_ids(local_device_ids)
    dist = torch.distributed
    if not dist.is_initialized():
        try:
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coordinator_address}",
                world_size=int(num_processes), rank=int(process_id),
                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        except Exception as e:
            pmesh.set_local_device_ids(None)
            raise taxonomy.HostLost(
                f"process {process_id} of {num_processes} could not join "
                f"the process group at {coordinator_address}: {e}") from e
    _initialized = True


def shutdown() -> None:
    """Leave the process group (a no-op outside one) and forget the
    ``local_device_ids`` it was joined with."""
    global _initialized
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    pmesh.set_local_device_ids(None)
    _initialized = False


@dataclass(frozen=True)
class RuntimeInfo:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int
    platform: str

    @property
    def is_multi_host(self) -> bool:
        return self.process_count > 1


def runtime_info(device=None) -> RuntimeInfo:
    """The topology seen from this process: its slots are those
    :func:`~fia_tpu_torch.parallel.mesh.make_mesh` lays on ``device``'s
    kind (``None``: CUDA where it is available, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    local = len(pmesh._local_slots(dev.type, dev.index))
    n = pmesh.process_count()
    return RuntimeInfo(process_index=pmesh.process_index(), process_count=n,
                       local_device_count=local,
                       global_device_count=local * n, platform=dev.type)


def _granules(devs) -> list[list]:
    """Slots grouped by the process that owns them (``process_index``),
    in process order; one group in one process."""
    by: dict = {}
    for d in devs:
        by.setdefault(int(d.process_index), []).append(d)
    return [by[k] for k in sorted(by)]


def make_hybrid_mesh(
    model_parallel: int = 1,
    axis_names: tuple[str, str] = ("data", "model"),
    devices=None,
    granules: list[list] | None = None,
    device=None,
) -> pmesh.Mesh:
    """``('data', 'model')`` mesh with the ``model`` axis inside a
    process: each process's slots (``devices``, default
    :func:`~fia_tpu_torch.parallel.mesh.init_pod_mesh` over ``device``'s
    kind) reshape to ``(n / model_parallel, model_parallel)`` and the
    processes stack along ``data``. ``granules`` overrides the grouping
    (one process can lay out a several-host mesh that way).

    ``model_parallel`` must divide every group's slot count (a global
    count is not enough: 2 processes x 2 slots cannot hold
    model_parallel=4 without a table gather crossing processes); raises
    ``ValueError`` otherwise rather than silently unsharding the
    tables."""
    if granules is not None:
        groups = [list(g) for g in granules]
    else:
        groups = _granules(
            list(pmesh.init_pod_mesh(device=device).devices.flat)
            if devices is None else list(devices))
    sizes = {len(g) for g in groups}
    if len(sizes) != 1:
        raise ValueError(
            f"granules must be equal-sized, got sizes {sorted(sizes)}")
    per = sizes.pop()
    if per % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide the "
            f"per-granule device count {per}")
    rows = []
    for g in groups:
        arr = np.empty(len(g), dtype=object)
        arr[:] = g
        rows.append(arr.reshape(per // model_parallel, model_parallel))
    return pmesh.Mesh(np.concatenate(rows, axis=0), axis_names)


def process_local_rows(n_global: int, mesh: pmesh.Mesh | None = None,
                       axis: str = "data") -> slice:
    """The contiguous row range of a global batch this process feeds.

    With ``mesh``: the union of the ``axis`` shards of this process's
    slots, ``n_global`` split evenly over the axis (it must divide it:
    pad the batch to a mesh multiple first). Without one: rows split
    evenly over the processes, the first ``n % count`` one longer."""
    if mesh is not None:
        size = int(mesh.shape[axis])
        if n_global % size:
            raise ValueError(
                f"n_global={n_global} does not divide the '{axis}' axis "
                f"(size {size}); shards must be even — pad the batch to "
                "a mesh multiple first")
        q = n_global // size
        me = pmesh.process_index()
        mine = sorted({c for s, c in zip(mesh.devices.flat,
                                          pmesh.axis_coords(mesh, axis))
                       if int(s.process_index) == me})
        if mine != list(range(mine[0], mine[-1] + 1)):
            raise ValueError(
                f"this process's shards along the '{axis}' axis are not "
                f"contiguous ({mine}); use a process-order mesh layout "
                "(make_hybrid_mesh) or feed rows per slot")
        return slice(mine[0] * q, (mine[-1] + 1) * q)
    p, n = pmesh.process_index(), pmesh.process_count()
    base, extra = divmod(n_global, n)
    start = p * base + min(p, extra)
    return slice(start, start + base + (1 if p < extra else 0))


def global_batch(mesh: pmesh.Mesh, local_rows, axis: str = "data",
                 global_rows: int | None = None) -> list:
    """Each of this process's slots' shard of a global batch of which the
    process holds only its own rows (:func:`process_local_rows`): one
    tree per slot, aligned with ``mesh.devices.flat``, exactly what
    :func:`~fia_tpu_torch.parallel.mesh.shard_along` of the global batch
    would give those slots (``None`` for another process's). Accepts an
    array or a dict/list of arrays sharing the leading dimension.

    ``global_rows``: the global row count (default: the local count times
    the process count)."""
    leaves: list = []
    pmesh._tree_map(lambda x: leaves.append(x), local_rows)
    n_local = int(np.shape(leaves[0])[0])
    n = (n_local * pmesh.process_count() if global_rows is None
         else int(global_rows))
    start = process_local_rows(n, mesh, axis).start
    size = int(mesh.shape[axis])
    q = -(-n // size)
    me = pmesh.process_index()
    out = []
    for slot, k in zip(mesh.devices.flat, pmesh.axis_coords(mesh, axis)):
        if int(slot.process_index) != me:
            out.append(None)
            continue

        def put(x, k=k, dev=slot.device):
            x = torch.as_tensor(np.asarray(x))
            lo = min(k * q, n) - start
            return x[lo: lo + max(0, min(q, n - k * q))].to(dev)

        out.append(pmesh._tree_map(put, local_rows))
    return out


def spans_processes(mesh: pmesh.Mesh | None) -> bool:
    """True when the mesh holds slots of more than one process."""
    if mesh is None:
        return False
    return len({int(d.process_index) for d in mesh.devices.flat}) > 1


def put_global(mesh: pmesh.Mesh, tree, axis: str | None = None) -> list:
    """Host arrays (the same on every process) on this process's slots:
    ``axis=None`` replicates (one copy a physical device, shared by its
    slots, :func:`~fia_tpu_torch.parallel.mesh.replicate`), an axis name
    splits dim 0 into that axis' contiguous shards
    (:func:`~fia_tpu_torch.parallel.mesh.shard_along`). One tree per
    slot, aligned with ``mesh.devices.flat``, ``None`` for another
    process's slot.

    Placement races a restarting worker: short bounded retries on the
    transient kinds absorb it, anything else surfaces untouched."""

    def place():
        inject.fire(sites.DISTRIBUTED_PUT_GLOBAL)
        if axis is None:
            return pmesh.replicate(mesh, tree)
        return pmesh.shard_along(mesh, tree, axis)

    return _PUT_RETRY.run(place, retry_on=taxonomy.TRANSIENT)


def allgather_object(obj) -> list:
    """``obj`` of every process, in process order (``[obj]`` in one
    process). A failed exchange raises ``HostLost``."""
    if pmesh.process_count() == 1:
        return [obj]
    out = [None] * pmesh.process_count()
    try:
        torch.distributed.all_gather_object(out, obj)
    except Exception as e:
        raise taxonomy.HostLost(
            f"a process-group exchange failed on process "
            f"{pmesh.process_index()}: {e}") from e
    return out


def gather_shards(mine: dict, n: int) -> list:
    """Every process's shard results in global shard order: ``mine``
    maps the indices of this process's shards to their host results; the
    result lists all ``n``. Each shard must be computed by exactly one
    process."""
    merged: dict = {}
    for part in allgather_object(mine):
        for k, v in part.items():
            if k in merged:
                raise ValueError(f"shard {k} computed by two processes")
            merged[k] = v
    missing = sorted(set(range(n)) - set(merged))
    if missing:
        raise ValueError(f"no process computed shard(s) {missing}")
    return [merged[k] for k in range(n)]


def fill_shards(parts: list) -> list:
    """``parts`` in global shard order, each this process's result or
    ``None`` for a shard another process runs: returned as it is when no
    entry is ``None``, else every process's entries (tensors moved to the
    host) all-gathered into their places (:func:`gather_shards`)."""
    if all(p is not None for p in parts):
        return parts

    def host(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    return gather_shards({k: pmesh._tree_map(host, p)
                          for k, p in enumerate(parts) if p is not None},
                         len(parts))
