"""Primary rays of every call completed in the window (width x height x
spp x frames) over the window, first call's start to last call's end."""


def read(s):
    walls = s["walls"]
    return s["rays_per_call"] * len(walls) / (walls[-1][1] - walls[0][0]) / 1e6
