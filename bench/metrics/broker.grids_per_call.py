"""Grids the fleet broker stacks into one engine call."""


def read(ctx):
    broker = ctx.get("broker")
    if not broker or not broker["engine_calls"]:
        return None
    return broker["grids"] / broker["engine_calls"]
