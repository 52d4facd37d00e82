"""Flax-layout CoreNet modules in PyTorch."""
