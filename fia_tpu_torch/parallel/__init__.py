"""The ``data``-axis device mesh (port of ``fia_tpu/parallel``): one
process drives every slot of its mesh. The multi-process runtime
(``parallel/distributed.py``) and row-sharded tables
(``parallel/sharded.py``) are ROADMAP Queue A.13b."""

from fia_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Slot,
    make_mesh,
    replicate,
    set_virtual_devices,
    shard_along,
    virtual_devices,
)
