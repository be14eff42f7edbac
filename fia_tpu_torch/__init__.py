"""fia_tpu_torch — the PyTorch/CUDA port of fia_tpu.

A second package beside the JAX one (``fia_tpu/``, the reference it is
held against). It imports ``torch`` and numpy only: never JAX, and never
a module of ``fia_tpu`` — what it needs from numpy-only reference
modules is copied here.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); without a CUDA device the default raises
(:func:`fia_tpu_torch.device.resolve_device`). The port so far runs the
influence queries (``InfluenceEngine.query_batch`` and ``query_many``:
the flat direct-solve program, whose score stage is a hand-written CUDA
kernel for each model, ``influence/kernels/csrc/mf_scores.cu`` and
``ncf_scores.cu``, and the padded program of the iterative solvers) for
the MF and NCF models, their training and leave-one-out retraining
(``train/``), and the paper's experiments (``eval/``, and the drivers
``python -m fia_tpu_torch.cli.rq1|rq2``).
"""

__version__ = "0.1.0"

from fia_tpu_torch._lazy import lazy_exports  # noqa: E402

# the reference's re-exports, imported on first use
__getattr__, __dir__ = lazy_exports(__name__, {
    "MF": "fia_tpu_torch.models.mf",
    "NCF": "fia_tpu_torch.models.ncf",
    "InfluenceEngine": "fia_tpu_torch.influence.engine",
})
