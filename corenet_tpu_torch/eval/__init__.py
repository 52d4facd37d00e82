"""Inference and evaluation."""
