"""Training: the minibatch trainer, leave-one-out retraining and
checkpoints."""

from fia_tpu_torch._lazy import lazy_exports  # noqa: E402

# the reference's re-exports, imported on first use
__getattr__, __dir__ = lazy_exports(__name__, {
    "Trainer": "fia_tpu_torch.train.trainer",
    "TrainConfig": "fia_tpu_torch.train.trainer",
    "checkpoint": "fia_tpu_torch.train.checkpoint",
})
