"""The failure taxonomy (port of ``fia_tpu/reliability/taxonomy.py``).

Every recovery decision — retry, halve, rebuild, surface — starts from
one question: what kind of failure was that? :func:`classify` answers
it from the exception's type and message. It keeps every signature of
the reference, so a fault injected by :mod:`fia_tpu_torch.reliability.
inject` (which replays the reference's TPU messages) classifies exactly
as it does there, and adds those PyTorch raises on a CUDA card:

- ``OOM``: ``torch.cuda.OutOfMemoryError`` (by type), "CUDA out of
  memory", cuBLAS's and cuSOLVER's ``*_STATUS_ALLOC_FAILED``: the
  allocator or a library handle could not get device memory, which a
  smaller dispatch can avoid;
- ``DEVICE_LOST``: CUDA's sticky errors (an illegal memory access or
  instruction, a device-side assert, an unspecified launch failure, a
  misaligned address, an uncorrectable ECC error). They poison the
  process's CUDA context: every later CUDA call fails, and no rebuild
  inside the process can survive, so they must not classify as
  ``WORKER`` (whose rebuild-and-retry would loop on a dead context
  until its deadline). The caller surfaces them, as the reference does
  on one device;
- ``HOST_LOST``: NCCL's watchdog timeout ("Watchdog caught collective
  operation timeout"), through the reference's own ``collective …
  timeout`` rule.

A kernel's own launch errors (the port's C entries return
``cudaGetLastError``'s code, e.g. "invalid configuration argument",
"too many resources requested for launch", and "out of memory" too)
and ``nvcc`` build failures stay unclassified, so they rise: no retry
or degradation hides a kernel that cannot run. Only a sticky error
that a C entry reports reads as ``DEVICE_LOST``.

A diverged LiSSA recursion returns a "successful" buffer full of NaNs:
no exception reaches the host, so that class is read off the fetched
host arrays (:func:`classify_payload`), and recovery is the solver
ladder (:mod:`fia_tpu_torch.reliability.policy`).
"""

from __future__ import annotations

import sys

import numpy as np


class FaultKind:
    """String constants for the failure kinds (stable public names)."""

    OOM = "oom"
    HOST_OOM = "host_oom"
    AMBIGUOUS = "ambiguous"
    WORKER = "worker"
    PREEMPTION = "preemption"
    NAN = "nan"
    DEADLINE = "deadline"
    DEVICE_LOST = "device_lost"
    HOST_LOST = "host_lost"


OOM = FaultKind.OOM
HOST_OOM = FaultKind.HOST_OOM
AMBIGUOUS = FaultKind.AMBIGUOUS
WORKER = FaultKind.WORKER
PREEMPTION = FaultKind.PREEMPTION
NAN = FaultKind.NAN
DEADLINE = FaultKind.DEADLINE
DEVICE_LOST = FaultKind.DEVICE_LOST
HOST_LOST = FaultKind.HOST_LOST

#: kinds whose recovery destroys no information: the same dispatch may
#: be retried
TRANSIENT = frozenset({WORKER, PREEMPTION, AMBIGUOUS})

#: kinds that say "this dispatch was too big": halving is the right move
SIZE_EVIDENCE = frozenset({OOM, AMBIGUOUS, WORKER})

#: the port's kernel build failure (kernels/common.py): never a device
#: fault, whatever nvcc's log quotes
_BUILD_FAILED = "CUDA kernel build failed"
#: a C entry's return code (kernels/common.launch_error): the kernel's
#: own failure, unless the code is a sticky error of earlier work
_LAUNCH_FAILED = "kernel launch failed: cudaError"
#: cuBLAS and cuSOLVER failing to allocate their workspace: out of device
#: memory, though the message never says so
_ALLOC_FAILED = ("CUBLAS_STATUS_ALLOC_FAILED", "CUSOLVER_STATUS_ALLOC_FAILED")
#: CUDA's sticky errors (the text of cudaGetErrorString): the context is
#: poisoned, every later CUDA call in the process fails
_STICKY_CUDA = (
    "an illegal memory access was encountered",
    "device-side assert triggered",
    "unspecified launch failure",
    "misaligned address",
    "uncorrectable ecc error",
    "an illegal instruction was encountered",
)


class DeadlineExpired(TimeoutError):
    """A reliability Deadline ran out (classified as ``DEADLINE``)."""


class NanPayload(FloatingPointError):
    """Non-finite values detected in a fetched result payload
    (classified as ``NAN``)."""


class DeviceLost(RuntimeError):
    """A device is gone (classified as ``DEVICE_LOST``)."""


class HostLost(RuntimeError):
    """A whole host is gone (classified as ``HOST_LOST``)."""


def _torch_oom(e: BaseException) -> bool:
    """``e`` is a ``torch.cuda.OutOfMemoryError``: checked only when
    torch is already imported, and without touching CUDA's state."""
    torch = sys.modules.get("torch")
    oom = getattr(getattr(torch, "cuda", None), "OutOfMemoryError", None)
    return oom is not None and isinstance(e, oom)


def classify(e: BaseException) -> str | None:
    """Classify a failure for the retry and degradation layers.

    Exception types first (the deadline and NaN markers, host
    :class:`MemoryError`, CUDA's out-of-memory error), then the message
    signatures in evidence order: definite OOM, host loss, device loss
    (CUDA's sticky errors among them), preemption, the ambiguous
    compile-helper wrap, worker death. ``None`` for anything
    unrecognised, for a failed kernel build whatever its log says, and
    for a kernel's own launch failure (a sticky CUDA error a C entry
    reports aside) — callers must re-raise those.
    """
    if isinstance(e, DeadlineExpired):
        return DEADLINE
    if isinstance(e, NanPayload):
        return NAN
    if isinstance(e, HostLost):
        return HOST_LOST
    if isinstance(e, DeviceLost):
        return DEVICE_LOST
    if isinstance(e, MemoryError):
        return HOST_OOM
    if _torch_oom(e):
        return OOM
    s = str(e)
    if _BUILD_FAILED in s:
        return None
    if _LAUNCH_FAILED in s:
        low = s.lower()
        return (DEVICE_LOST if any(sig in low for sig in _STICKY_CUDA)
                else None)
    if ("RESOURCE_EXHAUSTED" in s or "out of memory" in s.lower()
            or any(sig in s for sig in _ALLOC_FAILED)):
        return OOM
    low = s.lower()
    if (
        ("collective" in low and ("timed out" in low or "timeout" in low))
        or ("coordination service" in low and (
            "unavailable" in low
            or "disconnect" in low
            or "heartbeat" in low
        ))
        or ("host" in low and "unreachable" in low)
    ):
        return HOST_LOST
    if (
        "device lost" in low
        or "lost device" in low
        or ("device" in low and "unhealthy state" in low)
        or any(sig in low for sig in _STICKY_CUDA)
    ):
        return DEVICE_LOST
    if "preempt" in low or "maintenance event" in low:
        return PREEMPTION
    if "tpu_compile_helper subprocess exit code" in s:
        return AMBIGUOUS
    if (
        "worker process crashed or restarted" in s
        or "kernel fault" in s
        or ("UNAVAILABLE" in s and "TPU worker" in s)
        or (
            "TPU backend error" in s
            and not any(k in s for k in ("compile", "lower", "Mosaic"))
        )
    ):
        return WORKER
    return None


def classify_payload(*arrays) -> str | None:
    """``NAN`` when any array holds a non-finite value, else ``None``;
    ``None`` entries are skipped (lazy result fields)."""
    for a in arrays:
        if a is None:
            continue
        a = np.asarray(a)
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            return NAN
    return None
