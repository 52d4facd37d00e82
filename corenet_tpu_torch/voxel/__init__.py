"""Voxelization for the on-device ground truth: bit-packed grids and their
interior fill, the blocked triangle rasterizer, the general rasterizer with
the dense fill and label composition, and ray-parity voxelization."""
