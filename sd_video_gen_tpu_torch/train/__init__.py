"""Training: the train / eval step, Adam, checkpoints, metrics, the Trainer."""
