"""Command-line entry points: the eval and demo CLIs."""
