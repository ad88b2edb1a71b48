"""Share of fold lookups (enumeration and verification caches) that
missed and computed: ``folding.misses`` over ``folding.lookups``."""
from bench.metrics._spans import counter


def read(ctx):
    lookups = counter(ctx, "folding.lookups")
    if not lookups:
        return None
    return counter(ctx, "folding.misses") / lookups
