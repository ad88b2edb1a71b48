"""Share of the traced window with no operation on the device."""
from bench.layerread import device_idle


def read(ctx):
    return device_idle(ctx)
