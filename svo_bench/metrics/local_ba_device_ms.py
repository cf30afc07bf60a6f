"""local_ba_device_ms: device time of the work launched inside the
handler's `local_ba` range, per local BA call of the profiled stretch."""


def read(ctx):
    calls = ctx["stretch"].get("ranges", {}).get("local_ba", [])
    return sum(us for _, us in calls) / len(calls) / 1e3 if calls else None
