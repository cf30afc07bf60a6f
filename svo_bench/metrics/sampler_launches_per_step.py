"""sampler_launches_per_step: growth of the program's own counter
`LAUNCHES["sample_patches_kernel"]` over the window, per batched step."""


def read(ctx):
    if not ctx["units"] or ctx.get("launches") is None:
        return None
    return ctx["launches"]["sample_patches_kernel"] / len(ctx["units"])
