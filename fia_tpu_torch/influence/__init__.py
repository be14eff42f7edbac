"""Influence engine, its gradient and solver primitives, and the
hand-written score kernels."""

from fia_tpu_torch._lazy import lazy_exports  # noqa: E402

# the reference's re-exports, imported on first use
__getattr__, __dir__ = lazy_exports(__name__, {
    "InfluenceEngine": "fia_tpu_torch.influence.engine",
    "InfluenceResult": "fia_tpu_torch.influence.engine",
    "grads": "fia_tpu_torch.influence.grads",
    "hvp": "fia_tpu_torch.influence.hvp",
    "solvers": "fia_tpu_torch.influence.solvers",
})
