"""Inference-side pieces of the training code."""
