"""Host time of the simulator, policy and torus a job: the runs'
``sim_s`` less the seconds their queries spent parked in the broker."""


def read(ctx):
    if not ctx.get("jobs") or "broker" not in ctx:
        return None
    return (ctx["sim_s"] - ctx["broker"]["park_s"]) / ctx["jobs"] * 1e3
