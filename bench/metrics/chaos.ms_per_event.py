"""Host milliseconds a chaos event (``sim/simulator.py``,
``sim/faults.py``): the total seconds of the program's ``chaos.fault``
and ``chaos.repair`` spans (victim search, eviction, the model's fail or
repair, the victims' replans) over its ``chaos.events`` counter. A
window with no chaos event, or without traces, reads as nothing."""
from bench.metrics._spans import counter, span_total_s


def read(ctx):
    events = counter(ctx, "chaos.events")
    if not events:
        return None
    total_s = (span_total_s(ctx, "chaos.fault")
               + span_total_s(ctx, "chaos.repair"))
    return total_s / events * 1e3
