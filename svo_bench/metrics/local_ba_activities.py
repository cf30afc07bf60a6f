"""local_ba_activities: device activities launched inside the handler's
`local_ba` range, per local BA call of the profiled stretch."""


def read(ctx):
    calls = ctx["stretch"].get("ranges", {}).get("local_ba", [])
    return sum(n for n, _ in calls) / len(calls) if calls else None
