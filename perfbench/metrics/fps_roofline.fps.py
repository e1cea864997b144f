"""FPS's and the nearest-centroid search's share of their roofline (%):
their least time at each traced request's live points and picks
(lib/counters.py:fps_bound_s + nearest_bound_s) over ``downsample_ms``,
the same work whatever implements it."""
from perfbench.lib import readers


def read(run):
    ms = readers.downsample_ms(run)
    bound = readers.downsample_bound_s(run)
    if not ms or bound is None:
        return None
    return 100.0 * bound / (ms * 1e-3)
