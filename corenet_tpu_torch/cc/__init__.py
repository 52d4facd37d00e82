"""The native C++ ground truth on the host (native.py)."""
