"""The patch functions' share of their roofline over the profiled stretch:
the least time of every call of the four tracking patch functions
(`reference/bounds.py`, from the call's own arguments) over the device
time of the work launched inside the range around it, in percent."""


def read(ctx):
    calls = [(least, dev) for least, dev in ctx.get("kernel_calls", [])
             if dev > 0]
    if not calls:
        return None
    return 100.0 * sum(x for x, _ in calls) / sum(d for _, d in calls)
