"""Training: the phases and the Trainer, Adam, evaluation, early stop and
checkpoints (params and train states, in the JAX package's format)."""
