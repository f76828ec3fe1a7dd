"""95th percentile of one call's wall (the call to its u8 images on the
host) over every call of the window, in ms."""

import numpy as np


def read(s):
    walls = [(b - a) * 1e3 for a, b in s["walls"]]
    return float(np.percentile(walls, 95))
