"""Color palette for qualitative visualization.

A copy of corenet_tpu/viz/colors.py: 17 entries, entry 0 is negative ⇒
transparent/background; entries 1+ color object classes / mesh indices.
"""

import numpy as np

DEFAULT_COLOR_PALETTE = np.array([
    [-1.0, -1.0, -1.0],        # 0: transparent / background
    [0.894, 0.102, 0.110],     # red
    [0.216, 0.494, 0.722],     # blue
    [0.302, 0.686, 0.290],     # green
    [0.596, 0.306, 0.639],     # purple
    [1.000, 0.498, 0.000],     # orange
    [0.969, 0.506, 0.749],     # pink
    [0.651, 0.337, 0.157],     # brown
    [0.400, 0.761, 0.647],     # teal
    [0.988, 0.553, 0.384],     # salmon
    [0.553, 0.627, 0.796],     # steel blue
    [0.906, 0.541, 0.765],     # orchid
    [0.651, 0.847, 0.329],     # lime
    [1.000, 0.851, 0.184],     # yellow
    [0.898, 0.769, 0.580],     # tan
    [0.702, 0.702, 0.702],     # gray
    [0.121, 0.471, 0.216],     # dark green
], np.float32)
