"""Device microseconds of a fitmask kernel launch (profiler time by
kernel name over the program's launch counters)."""
from bench.layerread import fitmask_us_per_launch


def read(ctx):
    return fitmask_us_per_launch(ctx)
