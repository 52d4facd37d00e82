"""The training state, the training step (on batches with their
ground-truth grid) and the eval forward."""
