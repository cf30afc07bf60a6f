"""activities_per_step: device activities per profiled batched step."""


def read(ctx):
    n = [u["activities"] for u in ctx["stretch"].get("units", [])]
    return sum(n) / len(n) if n else None
