"""Host-side (numpy) preparation of triangle batches for the on-device
ground truth."""
