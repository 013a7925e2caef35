"""95th percentile (nearest rank) of the wall times of all the frames in
the window, each from its call to the device's synchronize."""
from gdbench import stats


def read(rec):
    return stats.percentile(rec.walls, 95)
