"""Device-mesh helpers (port of ``fia_tpu/parallel/mesh.py``).

The port's scaling axes for this workload are ``data`` and ``model``.
Along ``data`` (test-query batches in influence, minibatch rows and
leave-one-out lanes in training, train-row shards in the full-parameter
HVP) every shard runs the unchanged single-device program on its own
slice, with no collective (docs/design.md §15): one process enqueues
each of its shards' programs on the shard's slot's device and the host
stitches the results. Along ``model`` the embedding tables are
row-sharded (:mod:`fia_tpu_torch.parallel.sharded`, docs/design.md §20):
each ``data`` row of a 2-D ``('data', 'model')`` mesh holds one copy of
every table split over its ``model`` slots.

A mesh may span processes (:func:`init_pod_mesh`,
:mod:`fia_tpu_torch.parallel.distributed`): every slot carries the
``process_index`` of the process that owns it, a process runs only its
own slots' shards (:func:`local_slots`, :func:`physical_devices`), and
what crosses processes is gathered to every host in global slot order.

A :class:`Mesh` is an ordered array of device slots (:class:`Slot`: an
``id``, the ``process_index`` of the host that owns it, and the
``torch.device`` it runs on) with named axes. Entry points take an
optional mesh; ``None`` is the single-device engine.

Virtual slots: :func:`set_virtual_devices` / :func:`virtual_devices` lay
N slots with distinct ids over ONE physical device (``cuda:0``, or the
CPU), the counterpart of XLA's ``--xla_force_host_platform_device_count``.
The tests build their meshes on them on the CPU, and ``chip_smoke.py``
on one card. Virtual slots share the hardware: their timings measure the
mesh's overhead, never a speedup.

Hosts: every slot carries the ``process_index`` of the host that owns it
(0 in one process), and host loss (all of one host's slots dying at
once) is a failure granularity of its own — :func:`lost_host_ids` is the
liveness probe, :func:`surviving_mesh` accepts whole-host drops, and
:func:`mesh_fingerprint` keys on the host layout. :func:`virtual_hosts`
overlays a slot→host map so one process can exercise every
host-granularity path.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from fia_tpu_torch.device import resolve_device

# Armed by virtual_hosts()/set_virtual_hosts(): slot id -> host index.
# None means "trust the slot" (its process_index). Process-global like
# the topology it stands in for; arm it from the test thread.
_VIRTUAL_HOSTS: dict[int, int] | None = None
# Armed by virtual_devices()/set_virtual_devices(): the number of
# virtual slots laid over the first physical device, or None.
_VIRTUAL_DEVICES: int | None = None
# Set by distributed.initialize(local_device_ids=...): the CUDA ordinals
# this process lays its slots over, in order, or None (every device).
_LOCAL_DEVICE_IDS: tuple[int, ...] | None = None


@dataclass(frozen=True)
class Slot:
    """One device slot of a mesh: its ``id`` (unique within the mesh),
    the ``process_index`` of the host that owns it, and the
    ``torch.device`` its shard runs on (virtual slots share one)."""

    id: int
    process_index: int
    device: torch.device


class Mesh:
    """Named axes over an ndarray of :class:`Slot`: ``devices`` (with
    ``.flat`` and ``.size``), ``axis_names``, ``shape[axis]``."""

    def __init__(self, devices, axis_names):
        slots = list(np.asarray(devices, dtype=object).flat)
        arr = np.empty(len(slots), dtype=object)
        arr[:] = slots
        self.devices = arr.reshape(np.shape(devices))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh of shape {self.devices.shape} with axes "
                f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        slots = ", ".join(f"{s.id}@{s.device}" for s in self.devices.flat)
        return f"Mesh({self.shape}, [{slots}])"


def set_virtual_devices(n: int | None) -> None:
    """Lay ``n`` virtual slots over one physical device (None restores
    the real devices).

    With a count armed, :func:`make_mesh` builds its slots (ids 0..n-1)
    over the first device of the kind it is asked for — ``cuda:0``, or
    the CPU — and :func:`live_device_ids` reports all n alive while that
    device is. The slots share the hardware: a mesh over them runs each
    shard in turn on one device, so its timings measure overhead, not
    speedup (docs/design.md §15)."""
    global _VIRTUAL_DEVICES
    if n is not None and int(n) < 1:
        raise ValueError(f"virtual device count must be >= 1, got {n}")
    _VIRTUAL_DEVICES = None if n is None else int(n)


@contextmanager
def virtual_devices(n: int):
    """Scoped :func:`set_virtual_devices` for tests and smoke runs."""
    global _VIRTUAL_DEVICES
    prev = _VIRTUAL_DEVICES
    set_virtual_devices(n)
    try:
        yield
    finally:
        _VIRTUAL_DEVICES = prev


def set_virtual_hosts(mapping: dict[int, int] | None) -> None:
    """Overlay a slot-id→host-index map (None restores the slots' own).

    One process has every slot on host 0, which makes host-granularity
    code untestable. With a map armed, :func:`host_index` (and
    everything built on it: host fingerprints, host liveness,
    host-granular mesh shrinks) sees the overlay topology instead. Slots
    absent from the map fall back to their own ``process_index``.
    """
    global _VIRTUAL_HOSTS
    _VIRTUAL_HOSTS = None if mapping is None else {
        int(k): int(v) for k, v in mapping.items()
    }


@contextmanager
def virtual_hosts(mapping: dict[int, int]):
    """Scoped :func:`set_virtual_hosts` for tests and chaos scenarios."""
    global _VIRTUAL_HOSTS
    prev = _VIRTUAL_HOSTS
    set_virtual_hosts(mapping)
    try:
        yield
    finally:
        _VIRTUAL_HOSTS = prev


def host_index(device) -> int:
    """The host (process) index that owns slot ``device``; honours an
    armed :func:`virtual_hosts` overlay."""
    if _VIRTUAL_HOSTS is not None:
        h = _VIRTUAL_HOSTS.get(int(device.id))
        if h is not None:
            return h
    return int(device.process_index)


def mesh_hosts(mesh: Mesh | None) -> tuple[int, ...]:
    """Sorted distinct host indices a mesh spans (empty for no mesh)."""
    if mesh is None:
        return ()
    return tuple(sorted({host_index(d) for d in mesh.devices.flat}))


def set_local_device_ids(ids) -> None:
    """Lay this process's CUDA slots over only the ordinals ``ids``, in
    the order given (None: every visible device). Set by
    :func:`fia_tpu_torch.parallel.distributed.initialize`'s
    ``local_device_ids``; raises ``ValueError`` on an empty, negative or
    repeated list."""
    global _LOCAL_DEVICE_IDS
    if ids is None:
        _LOCAL_DEVICE_IDS = None
        return
    ids = tuple(int(i) for i in ids)
    if not ids or min(ids) < 0 or len(set(ids)) != len(ids):
        raise ValueError(
            f"local_device_ids must be distinct CUDA ordinals >= 0, got "
            f"{list(ids)}")
    _LOCAL_DEVICE_IDS = ids


def _cuda_ordinals() -> list[int]:
    """The CUDA ordinals this process's slots lie on, in slot order."""
    if _LOCAL_DEVICE_IDS is not None:
        return list(_LOCAL_DEVICE_IDS)
    return list(range(torch.cuda.device_count()))


def _local_slots(kind: str, index: int | None) -> list[Slot]:
    """The slots this process can lay a mesh over, in id order: the
    armed virtual count over one device of ``kind`` (on CUDA, ``index``,
    else the first of this process's ordinals), else this process's CUDA
    devices (every one, ``cuda:0..count-1``, or the ``local_device_ids``
    it joined with, in their order), else the CPU."""
    if _VIRTUAL_DEVICES is not None:
        if kind == "cuda":
            first = (index if index is not None
                     else (_cuda_ordinals() or [0])[0])
            dev = torch.device("cuda", first)
        else:
            dev = torch.device("cpu")
        return [Slot(j, 0, dev) for j in range(_VIRTUAL_DEVICES)]
    if kind == "cuda":
        return [Slot(j, 0, torch.device("cuda", o))
                for j, o in enumerate(_cuda_ordinals())]
    return [Slot(0, 0, torch.device("cpu"))]


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group (0 with
    none): the ``process_index`` of the slots it owns."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def process_count() -> int:
    """Processes in the ``torch.distributed`` group (1 with none)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def local_slots(mesh: Mesh) -> list[Slot]:
    """The slots of ``mesh`` this process owns, in slot order (all of
    them in one process)."""
    me = process_index()
    return [s for s in mesh.devices.flat if int(s.process_index) == me]


def make_mesh(
    n_devices: int | None = None,
    axis_names: tuple[str, ...] = ("data",),
    shape: tuple[int, ...] | None = None,
    device=None,
) -> Mesh:
    """A mesh over the first n (default: all) local slots.

    ``device``: ``None`` (the CUDA devices; raises without CUDA, as
    every entry point does), ``"cuda"`` or ``"cpu"``. Slots are the real
    CUDA devices, or the armed :func:`set_virtual_devices` count over one
    device; asking for more slots than are visible raises."""
    dev = resolve_device(device)
    slots = _local_slots(dev.type, dev.index)
    if n_devices is not None:
        if int(n_devices) > len(slots):
            raise ValueError(
                f"a mesh of {n_devices} slots was asked for but only "
                f"{len(slots)} {dev.type} device(s) are visible; arm "
                "virtual slots with fia_tpu_torch.parallel.mesh."
                "set_virtual_devices(N) for a mesh over one device")
        slots = slots[: int(n_devices)]
    if shape is None:
        shape = (len(slots),) + (1,) * (len(axis_names) - 1)
    arr = np.empty(len(slots), dtype=object)
    arr[:] = slots
    return Mesh(arr.reshape(shape), axis_names)


def init_pod_mesh(
    axis_names: tuple[str, ...] = ("data",),
    shape: tuple[int, ...] | None = None,
    device=None,
    **distributed_kwargs,
) -> Mesh:
    """A mesh over every device of the job, so callers write one code
    path. ``distributed_kwargs`` (``coordinator_address``,
    ``num_processes``, ``process_id``) join the
    process group first (:func:`fia_tpu_torch.parallel.distributed.
    initialize`). In one process this is exactly :func:`make_mesh` over
    the local slots; across processes it is every process's local slots
    in process order, slot ``p * n + j`` being process p's j-th (each
    process must lay the same number n), each with its ``process_index``.
    A slot's ``device`` is the one its owner runs it on (the same local
    index on every process)."""
    from fia_tpu_torch.parallel import distributed

    if distributed_kwargs:
        distributed.initialize(**distributed_kwargs)
    nproc = process_count()
    if nproc == 1:
        return make_mesh(axis_names=axis_names, shape=shape, device=device)
    dev = resolve_device(device)
    mine = _local_slots(dev.type, dev.index)
    counts = distributed.allgather_object(len(mine))
    if len(set(counts)) != 1:
        raise ValueError(
            f"every process must lay the same number of slots, got {counts}")
    n = len(mine)
    slots = [Slot(p * n + j, p, mine[j].device)
             for p in range(nproc) for j in range(n)]
    if shape is None:
        shape = (len(slots),) + (1,) * (len(axis_names) - 1)
    arr = np.empty(len(slots), dtype=object)
    arr[:] = slots
    return Mesh(arr.reshape(shape), axis_names)


def mesh_fingerprint(mesh: Mesh | None):
    """Hashable identity of a mesh layout, ``None`` for no mesh: the
    axis names, the shape, the slot ids in order and each slot's host.

    Keys every built-program cache that must tell topologies apart (the
    engine's geometry keys, the service's consistency check); the same
    mesh rebuilt over the same slots computes the same fingerprint."""
    if mesh is None:
        return None
    return (
        tuple(mesh.axis_names),
        tuple(int(mesh.shape[a]) for a in mesh.axis_names),
        tuple(int(d.id) for d in mesh.devices.flat),
        tuple(host_index(d) for d in mesh.devices.flat),
    )


def live_device_ids() -> frozenset:
    """Ids of the slots whose physical device is visible right now.

    The liveness baseline for device-loss handling: a mesh referencing an
    id outside this set serves on a dead device. The real slots are the
    CUDA devices (``torch.cuda.device_count()``), or the CPU; armed
    virtual slots are all alive while a physical device is. Across
    processes, every process's slots (ids ``p * n + j``) count as alive:
    a dead peer shows as a failed exchange. A process that joined with
    ``local_device_ids`` has a slot for each of them, alive while its
    ordinal is visible. When the
    probe itself raises the empty set is returned (every slot then counts
    as lost, which is the honest answer)."""
    try:
        cuda = torch.cuda.is_available()
        phys = torch.cuda.device_count() if cuda else 1
        if not phys:
            return frozenset()
        if _VIRTUAL_DEVICES is not None:
            n, alive = _VIRTUAL_DEVICES, range(_VIRTUAL_DEVICES)
        elif cuda:
            ords = _cuda_ordinals()
            n, alive = len(ords), [j for j, o in enumerate(ords) if o < phys]
        else:
            n, alive = 1, range(1)
        return frozenset(p * n + j for p in range(process_count())
                         for j in alive)
    except Exception:
        return frozenset()


def lost_device_ids(mesh: Mesh | None) -> tuple[int, ...]:
    """Mesh slot ids no longer visible (sorted)."""
    if mesh is None:
        return ()
    live = live_device_ids()
    return tuple(sorted(
        int(d.id) for d in mesh.devices.flat if int(d.id) not in live
    ))


def lost_host_ids(mesh: Mesh | None) -> tuple[int, ...]:
    """Hosts *all* of whose mesh slots are dead (sorted). A host with any
    surviving slot is not listed: that is device loss, and the finer
    shrink handles it."""
    if mesh is None:
        return ()
    live = live_device_ids()
    by_host: dict[int, list[bool]] = {}
    for d in mesh.devices.flat:
        by_host.setdefault(host_index(d), []).append(int(d.id) in live)
    return tuple(sorted(h for h, alive in by_host.items() if not any(alive)))


def surviving_mesh(
    mesh: Mesh, lost_ids=(), lost_hosts=(), unnamed: str = "device"
) -> Mesh | None:
    """The shrunk mesh after device or host loss: survivors, original
    order.

    ``lost_ids``: slot ids known dead (:func:`lost_device_ids`).
    ``lost_hosts``: host indices known dead (:func:`lost_host_ids`) —
    every slot they own is dropped, unioned with ``lost_ids``. When both
    are empty — a dispatch fault classified ``device_lost`` /
    ``host_lost`` without naming the culprit, the common case for
    injected losses and terse errors — a deterministic victim is
    dropped: the LAST mesh slot (``unnamed="device"``) or the whole host
    owning it (``unnamed="host"``). The identity of the dropped unit
    never matters for results (every mesh size serves bit-identically,
    docs/design.md §15); only the shrink itself does. Returns ``None``
    when no slot would survive, or nothing would shrink (a named loss
    set disjoint from the mesh), so callers shed classified instead of
    rebuilding in place.

    A 2-D mesh with a trailing ``model`` axis keeps its trailing sizes
    while the survivors fill whole groups (excess survivors past the
    last full group are dropped too); only when they cannot fill one
    does it collapse to trailing size 1.
    """
    devs = list(mesh.devices.flat)
    lost = frozenset(int(i) for i in lost_ids)
    dead_hosts = frozenset(int(h) for h in lost_hosts)
    if dead_hosts:
        lost = lost | frozenset(
            int(d.id) for d in devs if host_index(d) in dead_hosts
        )
    if lost:
        keep = [d for d in devs if int(d.id) not in lost]
        if len(keep) == len(devs):
            return None
    elif unnamed == "host":
        victim = host_index(devs[-1])
        keep = [d for d in devs if host_index(d) != victim]
    else:
        keep = devs[:-1]
    if not keep:
        return None
    tail = tuple(int(mesh.shape[a]) for a in mesh.axis_names[1:])
    mp = 1
    for t in tail:
        mp *= t
    if mp > 1 and len(keep) >= mp:
        keep = keep[: (len(keep) // mp) * mp]
        shape = (len(keep) // mp,) + tail
    else:
        shape = (len(keep),) + (1,) * (len(mesh.axis_names) - 1)
    arr = np.empty(len(keep), dtype=object)
    arr[:] = keep
    return Mesh(arr.reshape(shape), mesh.axis_names)


# -- placement -----------------------------------------------------------
def data_slots(mesh: Mesh) -> list[Slot]:
    """The slot of each ``data`` shard, in shard order (the first slot
    of each row along the leading ``data`` axis)."""
    return [mesh.devices[k].flat[0] if mesh.devices.ndim > 1
            else mesh.devices[k] for k in range(int(mesh.shape["data"]))]


def physical_devices(mesh: Mesh) -> list[torch.device]:
    """The distinct ``torch.device`` s of this process's slots of a mesh,
    in slot order: where one replica of a replicated tensor lives."""
    out: list[torch.device] = []
    for s in local_slots(mesh):
        if s.device not in out:
            out.append(s.device)
    return out


def mesh_device(mesh: Mesh | None, device=None) -> torch.device:
    """The device of an entry point: ``device`` (None: CUDA, raising
    without it) when there is no mesh; over ``mesh``, this process's
    first slot's (where results are gathered and shared state lives), and a
    ``device`` the caller also passed must be of that kind."""
    if mesh is None:
        return resolve_device(device)
    mine = local_slots(mesh)
    if not mine:
        raise ValueError(f"process {process_index()} owns no slot of {mesh}")
    home = mine[0].device
    if device is not None and torch.device(device).type != home.type:
        raise ValueError(
            f"device {device!r} does not match the mesh's devices ({home})")
    return resolve_device(home)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def axis_coords(mesh: Mesh, axis: str) -> list[int]:
    """Each slot's coordinate along ``axis``, aligned with
    ``mesh.devices.flat``."""
    ax = mesh.axis_names.index(axis)
    return [int(c) for c in np.indices(mesh.devices.shape)[ax].reshape(-1)]


def shard_along(mesh: Mesh, tree, axis: str = "data", dim: int = 0) -> list:
    """Every leaf's ``dim`` split into the mesh axis' contiguous shards of
    ``ceil(n / size)`` (the last ragged or empty), each on its slot's
    device. Returns one tree per slot, aligned with ``mesh.devices.flat``
    (slots on one device at one coordinate of ``axis`` share their shard;
    a slot of another process holds ``None``)."""
    size = int(mesh.shape[axis])
    me = process_index()
    shared: dict = {}
    out = []
    for slot, k in zip(mesh.devices.flat, axis_coords(mesh, axis)):
        if int(slot.process_index) != me:
            out.append(None)
            continue
        if (slot.device, k) not in shared:

            def put(x, k=k, dev=slot.device):
                x = torch.as_tensor(x)
                q = -(-x.shape[dim] // size)
                return x.narrow(dim, min(k * q, x.shape[dim]),
                                max(0, min(q, x.shape[dim] - k * q))).to(dev)

            shared[(slot.device, k)] = _tree_map(put, tree)
        out.append(shared[(slot.device, k)])
    return out


def replicate(mesh: Mesh, tree) -> list:
    """``tree`` on every slot's device, ONE copy per physical device
    (slots that share a device share its tensors). Returns one tree per
    slot, aligned with ``mesh.devices.flat`` (``None`` for a slot of
    another process)."""
    copies = {dev: _tree_map(lambda x, dev=dev: torch.as_tensor(x).to(dev),
                             tree)
              for dev in physical_devices(mesh)}
    me = process_index()
    return [copies[s.device] if int(s.process_index) == me else None
            for s in mesh.devices.flat]
