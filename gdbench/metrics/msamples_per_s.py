"""Pixel samples a second: width x height x spp of every frame that
finished in the window over the window's seconds, in millions."""
from gdbench import stats


def read(rec):
    return stats.rate(rec.samples_per_frame, rec.frames, rec.window_s) / 1e6
