"""The device's idle share over the profiled stretch: one less the union
of the device activities' intervals over the stretch's wall time, in
percent."""


def read(ctx):
    st = ctx["stretch"]
    if not st.get("window_s"):
        return None
    return 100.0 * (1.0 - st["busy_s"] / st["window_s"])
