"""Data parallelism over processes (torch.distributed): parallel/mesh.py."""
