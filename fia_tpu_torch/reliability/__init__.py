"""The reliability layer (port of ``fia_tpu/reliability/``):

- ``taxonomy`` — the failure kinds and their classifier;
- ``policy`` — the injectable clock, deadlines, bounded retries and the
  query solver ladder;
- ``inject`` and ``sites`` — the deterministic fault-injection harness
  and its named sites (the reference's names);
- ``journal`` — the fingerprinted JSONL progress journal behind
  ``query_many``'s and the RQ1 driver's resume;
- ``artifacts`` — atomic, checksummed npz publishes, verification on
  read and quarantine.
"""

from fia_tpu_torch._lazy import lazy_exports  # noqa: E402

# the reference's re-exports, imported on first use
__getattr__, __dir__ = lazy_exports(__name__, {
    "artifacts": "fia_tpu_torch.reliability.artifacts",
    "inject": "fia_tpu_torch.reliability.inject",
    "journal": "fia_tpu_torch.reliability.journal",
    "policy": "fia_tpu_torch.reliability.policy",
    "taxonomy": "fia_tpu_torch.reliability.taxonomy",
})
