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
