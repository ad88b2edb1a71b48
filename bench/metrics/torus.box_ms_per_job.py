"""Host milliseconds a job in the static torus (``core/torus.py``): the
self time of the program's ``torus.*`` spans: ``torus.init`` (one a
run), ``torus.prefetch`` (the step's missing boxes), ``torus.find_box``
(the free-box search) and ``torus.commit`` (a fold's commit)."""
from bench.metrics._spans import layer_ms_per_job


def read(ctx):
    return layer_ms_per_job(ctx, "torus.")
