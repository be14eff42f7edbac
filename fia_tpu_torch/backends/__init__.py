"""The CPU reference engines (port of ``fia_tpu/backends``): torch
autograd double backprop + scipy ``fmin_ncg`` + a per-row scoring loop,
the reference implementation's architecture. They are the parity oracle
and the CPU baseline (BASELINE.md §3: measure our own CPU baseline,
report speedups against it); no path of the port runs them."""

from fia_tpu_torch.backends.torch_ref import TorchRefMFEngine  # noqa: F401
