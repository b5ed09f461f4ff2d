"""Training: AdamW on tensor trees, the train step, checkpoints, the Trainer."""
