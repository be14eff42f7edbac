"""Host-side helpers: durable writes (``io``) and the JSONL event log
(``logging``)."""
