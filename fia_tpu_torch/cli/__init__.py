"""Command-line drivers of the paper's experiments:
``python -m fia_tpu_torch.cli.rq1`` and ``python -m fia_tpu_torch.cli.rq2``."""
