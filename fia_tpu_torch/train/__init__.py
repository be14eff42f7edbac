"""Training: the minibatch trainer, leave-one-out retraining and
checkpoints."""
