"""Share of the window the host spent collecting garbage: the total of
the program's ``host.gc`` span over the window's seconds."""
from bench.metrics._spans import span_total_s


def read(ctx):
    gc_s = span_total_s(ctx, "host.gc")
    if gc_s is None or not ctx.get("window_s"):
        return None
    return gc_s / ctx["window_s"]
