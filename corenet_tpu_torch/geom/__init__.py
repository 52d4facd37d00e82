"""Homogeneous transforms (numpy, host side)."""

from corenet_tpu_torch.geom.transforms import (  # noqa: F401
    chain,
    look_at_lh,
    look_at_rh,
    ortho_lh,
    perspective_lh,
    perspective_rh,
    rotate,
    scale,
    transform_mesh,
    transform_points,
    transform_points_homogeneous,
    translate,
)
