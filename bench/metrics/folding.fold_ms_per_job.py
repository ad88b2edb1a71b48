"""Host milliseconds a job in fold enumeration and verification on
shapes not yet cached (``core/folding.py``): the self time of the
program's ``folding.*`` spans."""
from bench.metrics._spans import layer_ms_per_job


def read(ctx):
    return layer_ms_per_job(ctx, "folding.")
