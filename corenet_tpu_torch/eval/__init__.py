"""Inference and evaluation: super-resolution inference, the eval pipeline,
its metrics and results."""
