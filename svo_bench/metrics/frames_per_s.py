"""frames_per_s: tracked frames completed in the window over the window's
seconds (host clock, the window closing when its last frame's pose is on
the host)."""


def read(ctx):
    return len(ctx["units"]) * ctx["units_per_step"] / ctx["window_s"]
