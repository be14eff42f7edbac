"""The device mesh (port of ``fia_tpu/parallel``): the ``data`` axis
(``mesh.py``; each process drives its own slots), row-sharded embedding
tables over a ``model`` axis (``sharded.py``) and the multi-process
runtime on ``torch.distributed`` (``distributed.py``)."""

from fia_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Slot,
    make_mesh,
    replicate,
    set_virtual_devices,
    shard_along,
    virtual_devices,
)
from fia_tpu_torch.parallel.sharded import make_2d_mesh  # noqa: F401

from fia_tpu_torch._lazy import lazy_exports  # noqa: E402

# the reference's re-exports, imported on first use
__getattr__, __dir__ = lazy_exports(__name__, {
    "initialize": "fia_tpu_torch.parallel.distributed",
    "runtime_info": "fia_tpu_torch.parallel.distributed",
    "make_hybrid_mesh": "fia_tpu_torch.parallel.distributed",
    "global_batch": "fia_tpu_torch.parallel.distributed",
    "process_local_rows": "fia_tpu_torch.parallel.distributed",
})
