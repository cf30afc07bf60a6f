"""seq_frames_per_s: sequences times batched steps completed in the window
over the window's seconds (host clock; a step is complete when its poses
are on the host)."""


def read(ctx):
    return len(ctx["units"]) * ctx["units_per_step"] / ctx["window_s"]
