"""Qualitative visualization (host numpy, rendering on the device):
colors, cameras, isosurfaces, the renderers, artifacts, scenes."""
