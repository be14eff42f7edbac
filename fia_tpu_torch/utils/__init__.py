"""Host-side helpers: durable writes (``io``) and the JSONL event log
(``logging``)."""

from fia_tpu_torch._lazy import lazy_exports  # noqa: E402

# the reference's re-exports, imported on first use
__getattr__, __dir__ = lazy_exports(__name__, {
    "Timer": "fia_tpu_torch.utils.timing",
    "fenced_time": "fia_tpu_torch.utils.timing",
})
