"""frame_ms_p95: the 95th percentile of every frame of the window, each
timed from asking the feeder for it to its pose on the host (host clock)."""

import numpy as np


def read(ctx):
    return float(np.percentile([u["seconds"] for u in ctx["units"]], 95)
                 * 1e3)
