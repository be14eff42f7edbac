"""The paper's experiments: RQ1 (influence against leave-one-out
retraining, ``rq1``), RQ2 (the cost of a query, ``rq2``) and their
metrics."""

from fia_tpu_torch._lazy import lazy_exports  # noqa: E402

# the reference's re-exports, imported on first use
__getattr__, __dir__ = lazy_exports(__name__, {
    "pearson": "fia_tpu_torch.eval.metrics",
    "spearman": "fia_tpu_torch.eval.metrics",
    "test_retraining": "fia_tpu_torch.eval.rq1",
    "RetrainResult": "fia_tpu_torch.eval.rq1",
    "time_influence_queries": "fia_tpu_torch.eval.rq2",
    "TimingResult": "fia_tpu_torch.eval.rq2",
})
