"""feeder_wait_ms: the native feeder's host wait for decoded frames and
free pinned slots (`NativeFrameFeeder.wait_s`) over the window, per
frame."""


def read(ctx):
    if ctx.get("feeder_wait_s") is None or not ctx["units"]:
        return None
    return ctx["feeder_wait_s"] / len(ctx["units"]) * 1e3
