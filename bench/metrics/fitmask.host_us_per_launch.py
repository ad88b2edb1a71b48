"""Host microseconds of the fitmask engine a kernel launch: the self time
of the program's ``fitmask.*`` spans (occupancy to the device, the
wrappers' launch, the answers' copy back) over the launches the program
counted in the window."""
from bench.metrics._spans import layer_self_s


def read(ctx):
    self_s = layer_self_s(ctx, "fitmask.")
    launches = sum(ctx.get("launches", {}).values())
    if self_s is None or not launches:
        return None
    return self_s / launches * 1e6
