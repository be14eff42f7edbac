"""fia_tpu_torch — the PyTorch/CUDA port of fia_tpu.

A second package beside the JAX one (``fia_tpu/``, the reference it is
held against). It imports ``torch`` and numpy only: never JAX, and never
a module of ``fia_tpu`` — what it needs from numpy-only reference
modules is copied here.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); without a CUDA device the default raises
(:func:`fia_tpu_torch.device.resolve_device`). This slice ports the MF
flat direct-solve influence query (``InfluenceEngine.query_batch``),
whose score stage is a hand-written CUDA kernel
(``influence/kernels/csrc/mf_scores.cu``).
"""

__version__ = "0.1.0"
