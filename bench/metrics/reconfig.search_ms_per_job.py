"""Host milliseconds a job in the cube search (``core/reconfig.py``):
the self time of the program's ``reconfig.*`` spans (derived-state
refresh, shape fit masks, plan search)."""
from bench.metrics._spans import layer_ms_per_job


def read(ctx):
    return layer_ms_per_job(ctx, "reconfig.")
