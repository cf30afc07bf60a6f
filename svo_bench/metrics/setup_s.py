"""setup_s: process start to the first timed frame or step (CUDA init,
the kernels from the build cache, the inputs, bootstrap and warm-up)."""


def read(ctx):
    return ctx["setup_s"]
