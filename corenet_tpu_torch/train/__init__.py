"""The training state, the on-device ground truth, the training step and
the eval forward."""
