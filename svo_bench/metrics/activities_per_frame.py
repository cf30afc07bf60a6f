"""activities_per_frame: device activities per profiled frame that
inserted no keyframe (each frame's activities start inside its range)."""


def read(ctx):
    n = [u["activities"] for u, kf in zip(ctx["stretch"].get("units", []),
                                          ctx["stretch_keyframe"]) if not kf]
    return sum(n) / len(n) if n else None
