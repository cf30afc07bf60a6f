"""sampler_launches_per_frame: growth of the program's own counter
`LAUNCHES["sample_patches_kernel"]` over the window, per frame: sparse
alignment's iterations and level set-ups, and with 1D alignment
(`align1d_stack`) one launch an iteration of its loop."""


def read(ctx):
    launches = ctx.get("launches") or {}
    if not ctx["units"] or "sample_patches_kernel" not in launches:
        return None
    return launches["sample_patches_kernel"] / len(ctx["units"])
