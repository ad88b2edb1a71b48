"""Host milliseconds a job in the static torus (``core/torus.py``): the
self time of the program's ``torus.*`` spans (construction of empty
clones, box prefetch, free-box search, commit)."""
from bench.metrics._spans import layer_ms_per_job


def read(ctx):
    return layer_ms_per_job(ctx, "torus.")
