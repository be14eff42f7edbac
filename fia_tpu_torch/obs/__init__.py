"""Observability: for now only :func:`diag`, the stderr diagnostic
channel (the reference's ``fia_tpu/obs/`` also holds tracing, the
metrics registry and exporters; those come with ROADMAP Queue A.10)."""

from fia_tpu_torch.obs.diag import diag  # noqa: F401
