"""Set-up: process start to the first timed step or frame, the build of
the kernels (where the checkout has none yet), the data, the weights, the
checked first dispatch and the warm-up included."""


def read(ctx):
    return ctx["result"]["setup_s"]
