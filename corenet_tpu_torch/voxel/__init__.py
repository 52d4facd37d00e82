"""Voxelization for the on-device ground truth: bit-packed grids and their
interior fill, and the blocked triangle rasterizer."""
