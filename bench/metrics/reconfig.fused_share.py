"""Share of the cube search's free-count requests that the fleet broker
answered from the counts its fused mask pass had just computed, without
a round of their own: ``fc_cache_hits`` over ``fc_cache_hits`` plus
``fc_cache_misses``, summed over the window's fleets. Nothing where no
request asked for free counts (a placement path without the cube
search)."""


def read(ctx):
    brokers = [f["broker"] for f in ctx.get("fleets") or []
               if f and f.get("broker")]
    hits = sum(b.get("fc_cache_hits", 0) for b in brokers)
    asked = hits + sum(b.get("fc_cache_misses", 0) for b in brokers)
    if not asked:
        return None
    return hits / asked
