"""The failure taxonomy (copy of ``fia_tpu/reliability/taxonomy.py``).

Every recovery decision — retry, halve, rebuild, surface — starts from
one question: what kind of failure was that? :func:`classify` answers
it from the exception's type and message, with the reference's message
signatures, so a fault injected by :mod:`fia_tpu_torch.reliability.
inject` classifies exactly as it does in the reference. (CUDA's own
out-of-memory, illegal-address and NCCL-timeout messages get their
signatures with ROADMAP Queue A.10; until then only the generic "out of
memory" match covers CUDA.)

A diverged LiSSA recursion returns a "successful" buffer full of NaNs:
no exception reaches the host, so that class is read off the fetched
host arrays (:func:`classify_payload`), and recovery is the solver
ladder (:mod:`fia_tpu_torch.reliability.policy`).
"""

from __future__ import annotations

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


class DeadlineExpired(TimeoutError):
    """A reliability Deadline ran out (classified as ``DEADLINE``)."""


class NanPayload(FloatingPointError):
    """Non-finite values detected in a fetched result payload
    (classified as ``NAN``)."""


class DeviceLost(RuntimeError):
    """A device is gone (classified as ``DEVICE_LOST``)."""


class HostLost(RuntimeError):
    """A whole host is gone (classified as ``HOST_LOST``)."""


def classify(e: BaseException) -> str | None:
    """Classify a failure for the retry and degradation layers.

    Exception types first (the deadline and NaN markers, host
    :class:`MemoryError`), then the message signatures in evidence
    order: definite OOM, host loss, device loss, preemption, the
    ambiguous compile-helper wrap, worker death. ``None`` for anything
    unrecognised — callers must re-raise those.
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
    s = str(e)
    if "RESOURCE_EXHAUSTED" in s or "out of memory" in s.lower():
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
