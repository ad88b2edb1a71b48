"""Share of the runs' simulator time their queries spent parked in the
fleet broker."""


def read(ctx):
    broker = ctx.get("broker")
    if not broker or not ctx.get("sim_s") or not broker["engine_calls"]:
        return None
    return broker["park_s"] / ctx["sim_s"]
